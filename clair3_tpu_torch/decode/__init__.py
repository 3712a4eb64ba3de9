from clair3_tpu_torch.decode.decoder import (  # noqa: F401
    DecodeConfig,
    batch_decode,
    batch_decode_parallel,
    shutdown_decode_pool,
    decode_candidate,
    quality_score_from,
    compute_pl,
)
