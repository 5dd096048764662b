"""The slice's trainer path on the CPU: three parameter-synced training
steps of the flagship model with every layer through
``pipeline_fused_apply`` (``fusion_backend=pipeline``, K13's plain version
here) against the JAX trainer with the same backend (its Pallas kernel in
interpret mode), on the flagship's dynamic heat data cut to n = 16: losses
and the logged max_grad within rtol 1e-3, as tests/test_torch_trainer.py
holds the megakernel route (float32; the parameters synced after each step
because the adaptive controller amplifies last-bit differences).
"""

import numpy as np

from gncde_tpu import ops as jops
from gncde_tpu_torch import ops
from gncde_tpu_torch.ops import pipeline as tpl

from test_torch_trainer import STEPS, _run


def test_pipeline_backend_three_synced_flagship_steps_match_jax(monkeypatch):
    """Three training steps of the flagship model (Tsit5 + PID, checkpointed
    adjoint, AdamW + clip) on the flagship's dynamic heat data cut to n = 16,
    every layer through pipeline_fused_apply in both packages, parameters
    synced after each step: losses and max_grad within rtol 1e-3."""
    from gncde_tpu.data import ode_dataset as jds
    from gncde_tpu.data import pipeline as jpipe

    spec = jds.ODEDatasetSpec(name="heat", batch_size=2, dynamic_graph=True,
                              all_dynamic=True, num_nodes=16, time_tick=8,
                              method="Tsit5", amp_range=(1.0, 1.0), seed=1234)
    d = jpipe.get_split_train_data(spec, jds.generate(spec), "cubic")
    ops.set_fusion_backend("pipeline")
    jops.set_fusion_backend("pipeline")
    counted = tpl.fused_conv_stream.launches
    calls = []
    real = tpl.plain_conv_stream
    monkeypatch.setattr(tpl, "plain_conv_stream", lambda *a: calls.append(1) or real(*a))
    try:
        out = _run(d, np.float32, STEPS, sync=True)
    finally:
        ops.set_fusion_backend("auto")
        jops.set_fusion_backend("auto")
    # Every layer of every eval went through the pipeline apply (its plain
    # version on the CPU), forward and dM.
    assert calls and tpl.fused_conv_stream.launches == counted
    losses_t, grads_t = out["torch"]
    assert all(np.isfinite(losses_t)) and len(set(losses_t)) == STEPS
    np.testing.assert_allclose(losses_t, out["jax"][0], rtol=1e-3)
    np.testing.assert_allclose(grads_t, out["jax"][1], rtol=1e-3)
