"""Training of both nets: bins and labels, the focal loss, the AdamW step and the trainer."""
from clair3_tpu_torch.train.loss import focal_loss, multitask_loss  # noqa: F401
