"""Model substrate of the port: the dense decoder-only transformer."""

from .config import SHAPES, ModelConfig, ShapeConfig, shape_applicable
from .transformer import (count_params, decode_step, forward, init_cache,
                          init_params, param_layout, params_from_jax,
                          prefill)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "shape_applicable",
           "param_layout", "init_params", "params_from_jax", "count_params",
           "forward", "prefill", "decode_step", "init_cache"]
