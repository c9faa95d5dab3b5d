from .convert import (load_jax_params, load_jax_serving_params,  # noqa: F401
                      serving_params_to_numpy, shard_for_rank)
from .ernie import (ErnieConfig, ErnieEmbeddings, ErnieForPretraining,  # noqa: F401
                    ErnieLayer, ErnieModel, ErnieSelfAttention,
                    ErnieStageFirst, ErnieStageLast, ErnieStageMiddle,
                    ernie_pipeline_stages)
from .gpt import GPTBlock, GPTConfig, GPTForCausalLM, GPTModel  # noqa: F401
from .yolo import DarkNetTiny, YOLOv3, yolov3_default_anchors  # noqa: F401
