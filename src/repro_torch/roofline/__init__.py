from repro_torch.roofline.analysis import (H100, HW, collective_bytes,
                                           roofline_terms,
                                           summarize_memory)  # noqa: F401
