from .convert import params_from_numpy, params_to_numpy
from .llama import (LlamaConfig, decode_step, forward, generate, init_kv_cache,
                    init_params, loss_fn, make_train_step, prefill)
from .quantize import (QuantizedWeight, is_quantized, matmul,
                       quantize_weights_int8)

__all__ = ["LlamaConfig", "QuantizedWeight", "decode_step", "forward",
           "generate", "init_kv_cache", "init_params", "is_quantized",
           "loss_fn", "make_train_step", "matmul", "params_from_numpy",
           "params_to_numpy", "prefill", "quantize_weights_int8"]
