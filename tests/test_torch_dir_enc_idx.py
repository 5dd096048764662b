"""Port parity of the directed enc_idx field (``PermEquivDirGraphVectorField``
with ``enc_idx=True``) against the JAX package, on the CPU and in f32: the
field and its gradients on the dense backend and on the kernel route (K7,
then K6a per layer, K6a + K6b per layer backward: their plain versions on
the CPU) for ``enc_type`` ``emb`` and ``mlp``; the reference golden through
copied probe weights; the directed ``tiled_vf_eval_planes`` and its plane
gradients; ``save_weights`` files of the directed enc_idx TGB model; and the
three directed enc_idx configs at full width. The JAX field runs its own
Pallas route in interpret mode. Inputs are made with numpy from a seed and
given to both sides; JAX parameters are copied into the port by leaf path.

Tolerances, against the largest magnitude of the reference array: the field
1e-5 (f32 sums over n in another order; measured 2.3e-7), gradients 1e-4
(sums over n and the chain through the layers and the modulation MLPs;
measured up to 7.0e-6), the tiled eval's value and gradients 1e-4 as in
``tests/test_torch_enc_idx.py``, the golden at its own rtol 1e-4 and atol
1e-5.
"""

import pathlib

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from gncde_tpu import ops as jops
from gncde_tpu.interp import CubicInterpolation as JCubic
from gncde_tpu.interp import MatrixControl as JMatrixControl
from gncde_tpu.interp import backward_hermite_coefficients as j_bhc
from gncde_tpu.models.tgb import TGBGraphNeuralCDE as JTGBModel
from gncde_tpu.models.vector_fields import PermEquivDirGraphVectorField as JDVF
from gncde_tpu.nn import tree_serialise_leaves
from gncde_tpu.ops.pallas import tiled as jt
from gncde_tpu_torch import ops
from gncde_tpu_torch.configs import TGBGraphNeuralCDECfg, VectorFieldCfg
from gncde_tpu_torch.interp import CubicInterpolation, MatrixControl
from gncde_tpu_torch.models.vector_fields import PermEquivDirGraphVectorField as TDVF
from gncde_tpu_torch.nn import convert
from gncde_tpu_torch.ops import modulate as tmod
from gncde_tpu_torch.ops import pair as tp
from gncde_tpu_torch.run import common

from torch_parity_utils import copy_jax_to_torch, hermite_path, jax_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "goldens" / "perm_equiv_dir_enc_idx_vf.npz"
CONFIGS = ("trade_perm_equiv_dir_enc_idx_gncde.yaml", "genre_perm_equiv_dir_enc_idx_gncde.yaml",
           "genre_synth_perm_equiv_dir_enc_idx_gncde.yaml")


def _rel(got, ref):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


@pytest.fixture
def backends():
    yield
    jops.set_fusion_backend("auto")
    ops.set_fusion_backend("auto")


def _asymmetric_path(rng, B, T, n):
    ts, A = hermite_path(rng, B, T, n)
    return ts, A + np.triu(rng.uniform(0.0, 0.2, A.shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# The field
# ---------------------------------------------------------------------------

N, H, L, B, T, D = 20, 4, 2, 2, 5, 6


@pytest.fixture(scope="module", params=["emb", "mlp"])
def field_case(request):
    """The JAX directed enc_idx field on its Pallas route (interpret mode,
    tile 8: n = 20 is ragged) and its gradients of sum(f * W), with the
    port's field holding the same weights."""
    enc_type = request.param
    rng = np.random.default_rng(31)
    ts, A = _asymmetric_path(rng, B, T, N)
    t = (ts[:, 1] + np.array([0.03, 0.11])).astype(np.float32)
    Z = rng.normal(size=(B, N, H)).astype(np.float32)
    W = rng.normal(size=(B, N, H)).astype(np.float32)
    coeffs = jax.vmap(j_bhc)(jnp.asarray(ts), jnp.asarray(A))
    kw = dict(input_dim=H, hidden_dim=H, output_dim=H, num_layers=L, data_embed_dim=1,
              num_nodes=N, enc_idx=True, enc_type=enc_type, idx_dim=D)
    vf_j = JDVF(**kw, key=jr.PRNGKey(32))
    vf_t = TDVF(**kw, generator=torch.Generator().manual_seed(0))
    copy_jax_to_torch(vf_j, vf_t)

    def loss(vf, Z_):
        out = jax.vmap(lambda ts_, c_, t_, z_: vf(t_, z_, JMatrixControl(JCubic(ts_, c_))))(
            jnp.asarray(ts), coeffs, jnp.asarray(t), Z_)
        return jnp.sum(out * W), out

    mp = pytest.MonkeyPatch()
    mp.setattr(jt, "pick_tile", lambda n_: 8)
    jops.set_fusion_backend("megakernel")
    try:
        (_, ref), (g_vf, g_z) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            vf_j, jnp.asarray(Z))
    finally:
        jops.set_fusion_backend("auto")
        mp.undo()
    planes = tuple(torch.tensor(np.asarray(c)) for c in coeffs)
    return dict(ts=ts, t=t, Z=Z, W=W, planes=planes, vf_t=vf_t, ref=np.asarray(ref),
                g_z=np.asarray(g_z), g_vf=jax_leaves(g_vf))


@pytest.mark.parametrize("backend", ["dense", "megakernel"],
                         ids=["port-dense", "port-kernel-route"])
def test_dir_enc_idx_field_matches_jax(field_case, backend, backends, monkeypatch):
    """The port's directed enc_idx field, value and the gradients of Z,
    every layer (the 11-term basis), idx_enc and both MLPs, against the JAX
    field's Pallas route. On the kernel route one K7 per eval, per layer one
    K6a forward and one K6a + one K6b backward."""
    c = field_case
    vf = c["vf_t"]
    calls = []
    for mod, name in ((tmod, "plain_modulate_pair"), (tp, "plain_pair"),
                      (tp, "plain_pair_dw")):
        def wrapped(*a, _name=name, _f=getattr(mod, name)):
            calls.append(_name)
            return _f(*a)

        monkeypatch.setattr(mod, name, wrapped)
    ops.set_fusion_backend(backend)
    vf.zero_grad(set_to_none=True)
    Z = _t(c["Z"]).requires_grad_(True)
    out = vf(torch.tensor(c["t"]), Z, MatrixControl(CubicInterpolation(torch.tensor(c["ts"]),
                                                                       c["planes"])))
    (out * _t(c["W"])).sum().backward()
    want = ([] if backend == "dense" else
            ["plain_modulate_pair"] + ["plain_pair"] * 2 * L + ["plain_pair_dw"] * L)
    assert sorted(calls) == sorted(want)
    assert _rel(out, c["ref"]) <= 1e-5
    assert _rel(Z.grad, c["g_z"]) <= 1e-4
    names = [k for k, _ in vf.named_parameters()]
    assert {"gnn_layers.0.param6_prime", "idx_enc.module.layers.0.weight"
            if vf.idx_enc.type == "mlp" else "idx_enc.module.weight",
            "msg_func_adj_deriv.layers.2.bias"} <= set(names)
    for name, p in vf.named_parameters():
        assert _rel(p.grad, c["g_vf"][name.replace(".", "/")]) <= 1e-4, name


class _FakeControl:
    """A control whose values are ``(t, A)`` and derivatives ``(1, dA)`` on
    the last axis: the golden's control (``tests/test_goldens.py``)."""

    def __init__(self, A, dA):
        self.A, self.dA = A, dA

    def evaluate(self, t):
        return torch.stack([torch.full_like(self.A, float(t[0])), self.A], -1)

    def derivative(self, t):
        return torch.stack([torch.ones_like(self.A), self.dA], -1)


def test_dir_enc_idx_golden_through_copied_probe_weights():
    """tests/goldens/perm_equiv_dir_enc_idx_vf.npz (made by running the
    reference): the JAX field from the golden's key seed, its weights
    copied into the port; the probe weights and the port's output at the
    golden's tolerance."""
    d = np.load(GOLDEN)
    Hd, n = int(d["hidden"]), int(d["n"])
    kw = dict(input_dim=Hd, hidden_dim=Hd, output_dim=Hd, num_layers=2, data_embed_dim=1,
              num_nodes=n, enc_idx=True, enc_type="emb", idx_dim=4)
    vf_j = JDVF(**kw, key=jr.PRNGKey(int(d["key_seed"])))
    vf_t = TDVF(**kw, generator=torch.Generator().manual_seed(0))
    copy_jax_to_torch(vf_j, vf_t)
    for key, p in (("l0_linear_w", vf_t.gnn_layers[0].conv_layer.linear.weight),
                   ("idx_emb", vf_t.idx_enc.module.weight)):
        np.testing.assert_allclose(p.detach().numpy(), d[f"probe_{key}"], rtol=5e-5,
                                   atol=1e-6)
    ctrl = _FakeControl(torch.tensor(d["A"])[None], torch.tensor(d["dA"])[None])
    with torch.no_grad():
        out = vf_t(torch.tensor([float(d["t0"])]), torch.tensor(d["feats"])[None], ctrl)
    np.testing.assert_allclose(out[0].numpy(), d["out"], rtol=1e-4, atol=1e-5)


def test_directed_tiled_vf_eval_planes_matches_jax():
    """The directed layer stack on materialised planes (the column sums
    enter the rank terms), values and the gradients of the planes, Z and
    every layer parameter, ragged (n = 20, tile 8), f32 planes."""
    n, Hh, Ll, Bb, tile = 20, 5, 2, 2, 8
    rng = np.random.default_rng(33)
    A = (rng.normal(0.05, 0.1, (Bb, n, n)) + np.triu(rng.uniform(0, 0.2, (Bb, n, n))))
    A = A.astype(np.float32)
    dA = rng.normal(0.0, 0.1, (Bb, n, n)).astype(np.float32)
    Z = rng.normal(size=(Bb, n, Hh)).astype(np.float32)
    W = rng.normal(size=(Bb, n, Hh)).astype(np.float32)
    kw = dict(input_dim=Hh, hidden_dim=Hh, output_dim=Hh, num_layers=Ll, data_embed_dim=1,
              num_nodes=n, enc_idx=True, enc_type="emb", idx_dim=4)
    vf_j = JDVF(**kw, key=jr.PRNGKey(34))
    vf_t = TDVF(**kw, generator=torch.Generator().manual_seed(0))
    copy_jax_to_torch(vf_j, vf_t)

    def jloss(vf, A_, dA_, Z_):
        out = jax.vmap(lambda a, da, z: jt.tiled_vf_eval_planes(a, da, z, vf, tile=tile))(
            A_, dA_, Z_)
        return jnp.sum(out * W), out

    (_, ref), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        vf_j, jnp.asarray(A), jnp.asarray(dA), jnp.asarray(Z))
    ins = [_t(A).requires_grad_(True), _t(dA).requires_grad_(True), _t(Z).requires_grad_(True)]
    out = tp.tiled_vf_eval_planes(*ins, vf_t)
    (out * _t(W)).sum().backward()
    assert _rel(out, ref) <= 1e-4
    for v, g, name in zip(ins, jg[1:], ("dA_plane", "ddA_plane", "dZ")):
        assert _rel(v.grad, g) <= 1e-4, name
    jl = jax_leaves(jg[0])
    for name, p in vf_t.gnn_layers.named_parameters(prefix="gnn_layers"):
        assert _rel(p.grad, jl[name.replace(".", "/")]) <= 1e-4, name


# ---------------------------------------------------------------------------
# Weights files and the configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("enc_type", ["emb", "mlp"])
def test_dir_enc_idx_save_weights_load_in_flatten_order(tmp_path, enc_type):
    """A JAX ``save_weights`` file of a directed enc_idx TGB model (the
    field listed twice: in the model and inside its CDE wrapper; idx_enc
    and both MLPs after the layer stack) loads into the port's model as
    copying by leaf path does, and the port writes the same file back."""
    n, Hh, E = 12, 4, 2
    vf_j = JDVF(input_dim=Hh, hidden_dim=Hh, output_dim=Hh * E * 2, num_layers=2,
                data_embed_dim=E, num_nodes=n, enc_idx=True, enc_type=enc_type, idx_dim=8,
                key=jr.PRNGKey(35))
    model_j = JTGBModel(vf_j, Hh, "cubic", method="Tsit5", return_sequence=False,
                        dt0=0.25, key=jr.PRNGKey(36))
    cfg = dict(name="tgb_graph_neural_cde", hidden_dim=Hh, interpolation="cubic",
               method="Tsit5", return_sequence=False, dt0=0.25,
               vector_field=dict(name="PermEquivDirGraphVectorField", hidden_dim=Hh,
                                 num_layers=2, data_embed_dim=E, num_nodes=n, enc_idx=True,
                                 enc_type=enc_type, idx_dim=8))
    path = str(tmp_path / "w.npz")
    tree_serialise_leaves(path, model_j)
    loaded = TGBGraphNeuralCDECfg.from_dict(cfg).build(torch.Generator().manual_seed(1))
    assert loaded.vector_field.enc_idx and loaded.vector_field.idx_enc.type == enc_type
    convert.load_jax_npz(loaded, path)
    copied = TGBGraphNeuralCDECfg.from_dict(cfg).build(torch.Generator().manual_seed(2))
    copy_jax_to_torch(model_j, copied)
    for (k, a), (_, b) in zip(loaded.state_dict().items(), copied.state_dict().items()):
        assert torch.equal(a, b), k
    convert.save_jax_npz(loaded, str(tmp_path / "w2.npz"))
    j, t = np.load(path), np.load(str(tmp_path / "w2.npz"))
    assert sorted(j.files) == sorted(t.files)
    for k in j.files:
        np.testing.assert_array_equal(j[k], t[k])


def _cfg(name):
    return common.safe_load((ROOT / "configs" / "tgb" / name).read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_dir_enc_idx_configs_build_at_full_width(name):
    """The reference's directed enc_idx configs build at full width: trade
    n = 255, 32 x 4 with the last layer 32 * 8 * 2 = 512 (the H * E * 2
    rule); genre n = 1505, 8 -> 8 -> 8 -> 128; an ``mlp`` index encoder of
    width 512 and two modulation MLPs 1025 -> 8 -> 8 -> 1 of K7's family."""
    cfg = _cfg(name)
    model = TGBGraphNeuralCDECfg.from_dict(cfg["model"]).build(torch.Generator().manual_seed(0))
    vf = model.vector_field
    n, outs = (255, [32, 32, 32, 512]) if name.startswith("trade") else (1505, [8, 8, 128])
    assert isinstance(vf, TDVF) and vf.enc_idx and vf.num_nodes == n
    assert [l.conv_layer.linear.out_features for l in vf.gnn_layers] == outs
    assert all(len(l.params) == 11 for l in vf.gnn_layers)
    assert vf.idx_enc.type == "mlp" and vf.idx_enc.node_embedding().shape == (n, 512)
    for mlp in (vf.msg_func_adj, vf.msg_func_adj_deriv):
        assert (mlp.in_size, mlp.width_size, mlp.depth) == (1025, 8, 2)
        assert tmod.modulate_supported(mlp)
    vcfg = VectorFieldCfg.from_dict(cfg["model"]["vector_field"])
    assert vcfg._output_dim() == outs[-1]
