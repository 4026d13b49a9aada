from .checkpoint import Checkpointer
from .convert import params_from_numpy, params_to_numpy
from .llama import (LlamaConfig, decode_step, forward, generate, init_kv_cache,
                    init_params, loss_fn, make_train_step, param_specs, prefill,
                    shard_params)
from .moe import (MoEConfig, init_moe_params, make_moe_train_step, moe_forward,
                  moe_loss_fn, moe_param_specs, shard_moe_params)
from .quantize import (QuantizedWeight, is_quantized, matmul,
                       quantize_weights_int8)

__all__ = ["Checkpointer", "LlamaConfig", "MoEConfig", "QuantizedWeight",
           "decode_step", "forward", "generate", "init_kv_cache",
           "init_moe_params", "init_params", "is_quantized", "loss_fn",
           "make_moe_train_step", "make_train_step", "matmul", "moe_forward",
           "moe_loss_fn", "moe_param_specs", "params_from_numpy",
           "params_to_numpy", "param_specs", "prefill", "quantize_weights_int8",
           "shard_moe_params", "shard_params"]
