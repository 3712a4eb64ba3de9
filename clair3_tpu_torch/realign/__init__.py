from clair3_tpu_torch.realign.realigner import (  # noqa: F401
    realign_reads_in_region,
    realign_bam_region,
    select_realignment_windows,
)
from clair3_tpu_torch.realign.dbg import consensus_haplotypes  # noqa: F401
from clair3_tpu_torch.realign.align import affine_local_align  # noqa: F401
