"""Two GAN steps of the flagship's phase-2 recipe through the fast train
decode (``optim.fast_train``) against the JAX package's
``make_train_step`` with ``fast_train``, through the harness of
``test_torch_port_train_step.py`` (same weights and batch, the port's
parameters carried into JAX before each step, metrics 1e-4 relative, each
gradient tensor 1e-4 of its max-abs, JAX's float64 step arbitrating a
miss). Both packages' stochastic signs are patched to the deterministic
sign: the fast decode's own import of it in the JAX package too."""

import jpdse_tpu.models.fast_train as jft
from test_torch_port_train_step import run_steps


def test_two_fast_train_steps_match_jax(monkeypatch):
    monkeypatch.setattr(jft, "stochastic_sign_ste", lambda x, key: jft.deterministic_sign_ste(x))
    _, state = run_steps("fast_train", False, 2, monkeypatch)
    assert state.cfg.optim.fast_train and state.fast_decode is not None
