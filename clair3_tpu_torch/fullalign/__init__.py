from clair3_tpu_torch.fullalign.extractor import create_fa_tensors, fa_region  # noqa: F401
