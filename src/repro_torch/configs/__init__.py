"""Config registry: importing this package registers the paper's own
SLM/LLM pair and the reference's dense configs (``glm4-9b``,
``llama3.2-1b``, ``qwen2-1.5b``, ``qwen1.5-110b``), ``mamba2-2.7b`` (ssm
family), ``zamba2-2.7b`` (hybrid family), ``qwen3-moe-235b-a22b`` and
``llama4-maverick-400b-a17b`` (moe family), ``llama-3.2-vision-90b``
(vlm family) and ``whisper-medium`` (audio family), each a copy of the
reference's file."""
from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    get_config,
    list_archs,
    register,
)
from repro_torch.configs.synera_pair import (  # noqa: F401
    SYNERA_LLM, SYNERA_SLM, tiny_pair)
from repro_torch.configs.glm4_9b import GLM4_9B  # noqa: F401
from repro_torch.configs.llama3_2_1b import LLAMA32_1B  # noqa: F401
from repro_torch.configs.qwen2_1_5b import QWEN2_1_5B  # noqa: F401
from repro_torch.configs.qwen1_5_110b import QWEN15_110B  # noqa: F401
from repro_torch.configs.mamba2_2_7b import MAMBA2_2_7B  # noqa: F401
from repro_torch.configs.zamba2_2_7b import ZAMBA2_2_7B  # noqa: F401
from repro_torch.configs.qwen3_moe_235b_a22b import (  # noqa: F401
    QWEN3_MOE_235B)
from repro_torch.configs.llama4_maverick_400b_a17b import (  # noqa: F401
    LLAMA4_MAVERICK)
from repro_torch.configs.llama_3_2_vision_90b import (  # noqa: F401
    LLAMA32_VISION_90B)
from repro_torch.configs.whisper_medium import WHISPER_MEDIUM  # noqa: F401

# the reference's assigned architectures (10, spanning 6 families), in its
# order: the dry run's ``--all`` sweep
ASSIGNED_ARCHS = [
    "glm4-9b",
    "llama3.2-1b",
    "qwen3-moe-235b-a22b",
    "llama-3.2-vision-90b",
    "llama4-maverick-400b-a17b",
    "whisper-medium",
    "qwen2-1.5b",
    "mamba2-2.7b",
    "zamba2-2.7b",
    "qwen1.5-110b",
]
