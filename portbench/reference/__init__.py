"""Plain PyTorch references, float32: the EdgeBERT classifier
(``albert_ref``) and the dense pre-LN decoder with its LM head after every
layer (``dense_ref``).  They import nothing of the program and take only
what the benchmark made (weights, tokens) and the program's outputs, which
they judge."""
import torch


def set_tf32(on: bool) -> None:
    """float32 matrix products in full float32 (off) or in TF32 (on: the
    control's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
