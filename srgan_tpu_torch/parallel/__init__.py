"""Multi-process training and data-parallel serving over ``torch.distributed``."""
