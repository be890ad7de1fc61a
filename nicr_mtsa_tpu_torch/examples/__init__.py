"""Runnable examples of the port (`python -m
nicr_mtsa_tpu_torch.examples.<name>`)."""
