"""Device resolution for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``.  The CPU is
used only when the caller asks for it; a CUDA request on a machine without
a GPU raises instead of continuing on the CPU.
"""
from __future__ import annotations

from typing import Any, Union

import torch

DeviceLike = Union[str, torch.device]


def use_parity_numerics() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card.

    TF32 keeps about three decimal digits, which would break the 1e-5 / 2e-5
    tolerances the port is held to against the JAX package.  PyTorch's
    defaults leave cuBLAS matmuls in float32 but let cuDNN convolutions use
    TF32, so both switches are set explicitly.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The torch.device to run on; raises when CUDA is asked for but absent.
    ``"meta"`` gives shapes without storage (the sharding rules read a
    110B-parameter tree that way, as the JAX package reads
    ``jax.eval_shape``'s)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path"
            )
        use_parity_numerics()
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev!r}: use 'cuda', 'cpu' or 'meta'")
    return dev


def draw_device(gen: torch.Generator, device: DeviceLike) -> torch.device:
    """Where a draw from ``gen`` for a leaf on ``device`` is made: on the
    generator's own device, or on the meta device when the leaf is meta (the
    shape alone: nothing is drawn or allocated)."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else gen.device


def tree_to(tree: Any, device: torch.device) -> Any:
    """A nested dict of tensors (or arrays) with every leaf on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)
