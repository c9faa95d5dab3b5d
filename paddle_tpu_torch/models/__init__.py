from .convert import (load_jax_params, load_jax_serving_params,  # noqa: F401
                      serving_params_to_numpy)
from .ernie import (ErnieConfig, ErnieEmbeddings, ErnieForPretraining,  # noqa: F401
                    ErnieLayer, ErnieModel, ErnieSelfAttention)
from .gpt import GPTBlock, GPTConfig, GPTForCausalLM, GPTModel  # noqa: F401
