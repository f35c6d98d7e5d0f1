"""Process entry points: ``gpu_engine`` runs the data-plane sidecar on the
card (the port of the JAX package's ``cmd/tpu_engine.py``)."""
