from .convert import load_jax_params  # noqa: F401
from .ernie import (ErnieConfig, ErnieEmbeddings, ErnieForPretraining,  # noqa: F401
                    ErnieLayer, ErnieModel, ErnieSelfAttention)
from .gpt import GPTBlock, GPTConfig, GPTForCausalLM, GPTModel  # noqa: F401
