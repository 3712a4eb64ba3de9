from clair3_tpu_torch.pileup.extractor import (  # noqa: F401
    PileupCandidate,
    PileupResult,
    pileup_region,
    candidate_tensors,
    create_pileup_tensors,
)
