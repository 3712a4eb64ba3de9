from clair3_tpu_torch.phase.external import (  # noqa: F401
    ExternalPhaser,
    ExternalPhaserError,
    parse_phased_vcf,
)
from clair3_tpu_torch.phase.phaser import (  # noqa: F401
    ReadBackedPhaser,
    refine_mec,
    rescue_phase_sets,
)
