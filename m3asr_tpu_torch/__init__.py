"""PyTorch/CUDA port of m3asr_tpu for NVIDIA Hopper (H100).

Imports torch and numpy, never JAX and nothing of m3asr_tpu.

The package-level API keeps the JAX package's: ``config``,
``load_yaml_config``, ``model_config_from_dict``, :func:`load_engine` and
:func:`build_engine`. The engines run on ``cuda`` unless the caller asks
for the CPU (``device="cpu"``).
"""

__version__ = "0.1.0"

from m3asr_tpu_torch import config  # noqa: F401
from m3asr_tpu_torch.config import (load_yaml_config,  # noqa: F401
                                    model_config_from_dict)


def load_engine(engine_dir: str, device=None):
    """Load a built engine directory."""
    from m3asr_tpu_torch.runtime.engine import Engine
    return Engine.load(engine_dir, device=device)


def build_engine(config_path: str, checkpoint_path=None, device=None,
                 **engine_kwargs):
    """YAML + torch checkpoint -> Engine (the library twin of the build
    CLI); without a checkpoint, seeded random weights (seed 0).
    ``engine_kwargs`` are EngineConfig's."""
    import torch

    from m3asr_tpu_torch import checkpoint as ckpt
    from m3asr_tpu_torch.device import resolve_device
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

    dev = resolve_device(device)
    cfg = load_yaml_config(config_path)
    if checkpoint_path:
        sd = ckpt.load_torch_checkpoint(checkpoint_path)
        params = ckpt.convert_encoder(sd, cfg)
    else:
        from m3asr_tpu_torch.models.registry import get_family
        params = get_family(cfg.nnet_proto).init(
            cfg, torch.Generator(device=dev).manual_seed(0))
    return Engine(cfg, params, EngineConfig(**engine_kwargs), device=dev)
