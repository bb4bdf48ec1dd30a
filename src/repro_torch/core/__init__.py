"""Container-style environment runtime (PyTorch port).

EnvImage/Imagefile/Registry  -- layered content-addressed images
Container/Runtime            -- runtime instantiation + writable overlay
CompileCache                 -- in-memory cache of built serve steps

Lazy attribute resolution keeps submodules cycle-free.
"""

_EXPORTS = {
    "CompileCache": "repro_torch.core.compile_cache",
    "Container": "repro_torch.core.container",
    "EnvImage": "repro_torch.core.image",
    "ImageBuilder": "repro_torch.core.image",
    "Layer": "repro_torch.core.image",
    "parse_imagefile": "repro_torch.core.imagefile",
    "render_imagefile": "repro_torch.core.imagefile",
    "Registry": "repro_torch.core.registry",
    "TransferStats": "repro_torch.core.registry",
    "Runtime": "repro_torch.core.runtime",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(_EXPORTS[name])
        return getattr(mod, name)
    raise AttributeError(f"module 'repro_torch.core' has no attribute {name!r}")
