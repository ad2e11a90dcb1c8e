"""Model zoo on plain tensors: parameters are nested dicts in the JAX
package's layouts, applied by functions taking them explicitly.

So far the dense GQA models (every block ``attn:dense``) are ported, with
decode attention through kernel B8; the other block kinds raise
``NotImplementedError``.
"""

from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models import transformer  # noqa: F401
