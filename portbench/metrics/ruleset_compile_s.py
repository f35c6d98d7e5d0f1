"""Seconds of the ruleset compile that served the measured window: the sum
of the stages (parse, lowering, automata, planning, build_model, upload) of
the newest record on the program's compile log
(``observability/tracing.py::COMPILES``) that ended before ``c0.t``. None
without the compile log (a program that has none) or a record."""


def read(run):
    try:
        from coraza_kubernetes_operator_tpu_torch.observability.tracing import COMPILES
    except ImportError:
        return None
    recs = COMPILES.records(run.c0["t"])
    return recs[-1].total_s if recs else None
