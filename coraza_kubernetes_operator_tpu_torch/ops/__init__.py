"""Device operators: byte transforms, DFA scans and the conv-segment matcher.

- ``transforms`` — Seclang byte transforms over ``[N, L]`` uint8 tensors.
- ``dfa``        — dense stacked-DFA banks (kernel ``cko_scan_dense``).
- ``dfa_gather`` — joint-byte-class hot-tier banks (kernel ``cko_scan_gather``).
- ``dfa_flat``   — fused multi-bank flat-slot bins (kernel ``cko_scan_flat``).
- ``segment``    — conv-segment matcher (``conv1d`` + bitmap algebra).
- ``kernels``    — builds ``csrc/`` with nvcc at first use and binds it.

Each scan wrapper takes its plain PyTorch version for CPU tensors only;
on a CUDA tensor it launches its kernel or raises.
"""

from .dfa import DFABank, scan_dfa_bank, stack_dfas  # noqa: F401
from .dfa_gather import (  # noqa: F401
    GatherBank,
    plan_gather_bins,
    scan_gather_bank,
    stack_gather_bank,
)
from .dfa_flat import FlatBank, build_flat_bank, plan_flat_bins, scan_flat_bank  # noqa: F401
