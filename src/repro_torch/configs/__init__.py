"""Config registry: importing this package registers the paper's own
SLM/LLM pair.  The other architecture configs of the reference wait for
the slices that port their families."""
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
