"""The LM scaffold of the port: the dense decoder and its serving path.

``Model`` (``model.py``), ``DecodeEngine`` (``decode.py``: KV cache, prefill,
one-token decode) and ``generate.greedy_generate``; the configs are in
``repro_torch.configs``.  The reference is ``repro.models``.
"""

from repro_torch.models.config import ModelConfig, reduced
from repro_torch.models.model import Model
from repro_torch.models.decode import DecodeEngine
