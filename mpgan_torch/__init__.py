"""PyTorch/CUDA port of the multi-pass GAN for volumetric fluid super-resolution.

A package of its own beside ``mpgan_tpu`` (the JAX reference). It imports
torch, numpy and the standard library only. Public functions keep the JAX
package's layouts — NHWC slices ``(B, H, W, C)`` and volumes
``(Z, Y, X, C)`` — so the two can be compared like for like.

Entry points run on CUDA unless the caller passes ``device="cpu"``
(:func:`mpgan_torch.device.resolve_device`).
"""

from mpgan_torch.device import resolve_device

__all__ = ["resolve_device"]
