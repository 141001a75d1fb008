"""PyTorch/CUDA port of vispeech_tpu's serving path (text → 44.1 kHz PCM).

Imports torch, never jax or the vispeech_tpu package.  Entry points run on
CUDA unless the caller passes ``device="cpu"``.
"""
