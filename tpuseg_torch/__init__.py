"""tpuseg_torch — the PyTorch/CUDA port of tpuseg for one NVIDIA H100.

The JAX package ``tpuseg`` stays the reference; this package imports
neither it nor JAX. Slice 1 serves the flagship ``mobilenetv2_unet``
through ``tpuseg_torch.infer.predictor.Predictor``, with the decoder's
fused upsample+concat+conv, the fused head and the colorize pass as
hand-written CUDA kernels (``tpuseg_torch/csrc``). Slice 2 trains it
through ``python -m tpuseg_torch.main`` (``tpuseg_torch.train.trainer``),
with the Lovász loss's histogram and lookup as CUDA kernels too.
"""
