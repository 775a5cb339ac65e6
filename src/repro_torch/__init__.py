"""EdgeBERT on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``repro`` that runs the deployed ALBERT-EdgeBERT
inference pass (AF8 weights, eNVM-read embeddings, hard attention spans,
entropy early exit, sentence-level DVFS) on hand-written sm_90a kernels.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
version.  The package imports neither ``jax`` nor anything of ``repro``.
"""
