"""Platforms: the MESH image layer resolved to one torch device.

``local`` -- the first CUDA card (``cuda:0``); this slice serves on one
             card, so the JAX package's (data, model) mesh collapses to a
             single device;
``cpu``   -- the host CPU. Only a caller that asks for it gets it (the CPU
             tests pass ``platform="cpu"``): no code path falls back to the
             CPU when CUDA is missing.

``pod`` and ``multipod`` (the JAX package's 256- and 512-chip meshes) come
with the distributed slice of the port; naming them here raises.
"""

from __future__ import annotations

import torch

# platform name -> device string. Resolution happens at call time, so
# importing this module never touches CUDA state.
PLATFORMS: dict[str, str] = {
    "local": "cuda:0",
    "cpu": "cpu",
}


def resolve_device(platform: str = "local") -> torch.device:
    """The torch device a platform name runs on. Raises when the platform
    needs CUDA and this process has no card."""
    try:
        name = PLATFORMS[platform]
    except KeyError:
        raise ValueError(
            f"unknown platform {platform!r}; expected one of {sorted(PLATFORMS)}"
        ) from None
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"platform {platform!r} runs on {name}, but CUDA is not available; "
            "pass platform='cpu' to run on the host CPU")
    return device
