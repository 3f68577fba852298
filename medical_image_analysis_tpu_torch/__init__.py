"""PyTorch port of ``medical_image_analysis_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its layout and
names (``ops``, ``models``, ``configs``, ``data``, ``train``, ``cli``,
``ckpt``, ``peft``, ``evalx``, ``utils``), imports torch and never jax,
and keeps its CUDA sources in ``csrc``. It serves and trains R2GenGPT
(ARM tower + Llama-family decoder with LoRA, beam search) with the fused
Mamba layer, forward and backward, as hand-written CUDA kernels.
"""

__version__ = "0.1.0"
