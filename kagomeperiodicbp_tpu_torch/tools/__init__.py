"""Measurement tools of the port (``python -m kagomeperiodicbp_tpu_torch.tools.<name>``)."""
