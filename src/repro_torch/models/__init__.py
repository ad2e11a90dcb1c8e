"""Model zoo on plain tensors: parameters are nested dicts in the JAX
package's layouts, applied by functions taking them explicitly.

Every assigned family is ported: dense GQA, sliding-window attention and
RG-LRU (recurrentgemma), RWKV6, mixtures of experts (llama4-scout,
deepseek-v3) and MLA with multi-token prediction (deepseek-v3). GQA
decode attention runs through kernel B8.
"""

from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models import transformer  # noqa: F401
