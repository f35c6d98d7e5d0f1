"""coraza_kubernetes_operator_tpu_torch — the WAF data plane in PyTorch and CUDA.

The serving path of ``coraza_kubernetes_operator_tpu`` (Seclang compile →
device tables → batched request-window evaluation), ported to PyTorch
with its DFA scan kernels written by hand in CUDA C++ for Hopper
(``csrc/``). Sub-packages mirror the JAX package so every module has a
counterpart of the same name:

- ``seclang``, ``compiler`` — parser and rule compiler (plain Python and
  numpy, kept as copies of the JAX package's modules);
- ``ops``      — byte transforms, DFA scans (CUDA kernels with plain
                 PyTorch twins) and the conv-segment matcher;
- ``models``   — ``WafModel`` (a dataclass of tensors) and its evaluation;
- ``engine``   — ``WafEngine``: tensorize, tier, match, post-match, decode.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
