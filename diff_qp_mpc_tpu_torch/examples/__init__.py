"""The port's runnable examples (``python -m
diff_qp_mpc_tpu_torch.examples.<name>``): the OptNet QP layer learning an
argmin mapping, and learning 4×4 Sudoku's rules as QP constraints."""
