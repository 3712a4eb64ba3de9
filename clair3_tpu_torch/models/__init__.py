"""The nets of the cascade, and the experimental binary scorer, in PyTorch."""

from clair3_tpu_torch.models.full_alignment import FullAlignmentNet  # noqa: F401
from clair3_tpu_torch.models.pileup import PileupNet  # noqa: F401
from clair3_tpu_torch.models.fb import FullAlignmentBinaryNet  # noqa: F401
