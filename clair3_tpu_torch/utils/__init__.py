from clair3_tpu_torch.utils.common import (  # noqa: F401
    BASIC_BASES,
    IUPAC_TO_ACGT,
    IUPAC_TO_NUM,
    convert_iupac_to_n,
    log_error,
    log_warning,
)
