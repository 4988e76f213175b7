"""The synthetic LM data pipeline (NumPy; no device)."""

from repro_torch.data.synthetic import SyntheticLM, make_batch  # noqa: F401
