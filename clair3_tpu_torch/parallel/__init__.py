"""Multi-process execution: ``parallel.distributed`` spreads ``call``'s
genome chunks over processes joined by ``torch.distributed``."""
