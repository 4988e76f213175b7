"""The LM zoo on one device: port of ``src/repro/models``.

``config.py`` (``ModelConfig``), ``layers.py``, ``attention.py`` (GQA and
MLA), ``ssm.py`` (Mamba2), ``moe.py`` (the local sort-based dispatch),
``transformer.py`` (the dense, MoE, SSM and hybrid decoders, token or
embedding inputs), ``encdec.py`` (the encoder-decoder), ``registry.py``
(``get_model``, ``input_specs``, ``reduced_config``) and ``convert.py``
(params to and from the reference, bitwise).
"""

from repro_torch.models.config import ModelConfig  # noqa: F401
