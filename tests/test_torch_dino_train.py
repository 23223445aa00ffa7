"""The port's DINO train step (tpu_ac_torch.train.dino) against tpu_ac's,
at tpu_ac's tiny test sizes, in f32 on the CPU.

Tolerances:
- loss and every gradient before the clip: 1e-5 relative (per parameter,
  in L2), against ``jax.value_and_grad`` of tpu_ac's student forward and
  ``dino_loss``: the same f32 ops summed in other orders.
- the state after 1 and 3 steps: 2e-6 absolute, except for the
  parameter elements whose gradient at the first step is below 1e-6
  (100 x Adam's eps).  Adam's first step is lr * g / (|g| + eps), about
  lr * sign(g): where |g| is near eps it swings across [-lr, lr] on the
  last bits of g, so those elements are held to 2 * lr a step.  The key
  third of each ``attn.qkv.bias`` is among them: softmax does not depend
  on a constant added to every logit of a row, so its gradient is zero
  and both packages compute rounding noise for it.
- paths that run the same ops in the same order (schedule tables against
  host scalars, k steps grouped against k single steps, remat against
  plain, uint8 crops against the same crops normalized on the host):
  equal.
- bf16 against f32: the loss within 0.05, as tpu_ac's own test holds it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ac.models.vit import ViTConfig as JViTConfig
from tpu_ac.train import dino as jd
from tpu_ac_torch.data.mvtec import IMAGENET_MEAN, IMAGENET_STD
from tpu_ac_torch.models.vit import ViTConfig
from tpu_ac_torch.train import dino as td

VIT_KW = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, img_size=32)
CFG_KW = dict(out_dim=64, local_crops_number=2, global_size=32,
              local_size=16, head_hidden_dim=32, head_bottleneck_dim=16,
              epochs=2, steps_per_epoch=4)
J_VIT, T_VIT = JViTConfig(**VIT_KW), ViTConfig(**VIT_KW)
J_CFG, T_CFG = jd.DINOConfig(**CFG_KW), td.DINOConfig(**CFG_KW)
LR = 1e-3
B = 4


def _scalars(freeze=False):
    return dict(lr=LR, wd=0.04, teacher_momentum=0.996, teacher_temp=0.04,
                freeze_last=freeze)


def _jscalars(freeze=False):
    return {k: (jnp.asarray(v) if k == "freeze_last" else jnp.float32(v))
            for k, v in _scalars(freeze).items()}


@pytest.fixture(scope="module")
def jstate():
    return jax.tree.map(np.asarray, jd.init_dino_state(0, J_VIT, J_CFG))


@pytest.fixture(scope="module")
def crops():
    rng = np.random.default_rng(11)
    g = rng.standard_normal((2 * B, 3, 32, 32)).astype(np.float32)
    l = rng.standard_normal((2 * B, 3, 16, 16)).astype(np.float32)
    return g, l


def _tstate(jstate):
    return td.dino_state_from_numpy(jstate, device="cpu")


def _flat(state):
    """{path: array} over every leaf of a state of either package."""
    out = {}
    for part in ("student", "teacher"):
        out.update({f"{part}/{k}": np.asarray(v)
                    for k, v in getattr(state, part).items()})
    opt = state.opt_state
    out.update({f"mu/{k}": np.asarray(v) for k, v in opt.mu.items()})
    out.update({f"nu/{k}": np.asarray(v) for k, v in opt.nu.items()})
    out["count"] = np.asarray(opt.count)
    out["center"] = np.asarray(state.center)
    out["step"] = np.asarray(state.step)
    return out


def _jgrads(jstate, g, l, center, temp):
    """tpu_ac's loss and gradients of the student at ``jstate``."""
    def jloss(student):
        t_out = jd.student_forward(
            jax.tree.map(jnp.asarray, jstate.teacher), jnp.asarray(g), None,
            J_VIT)
        s_out = jd.student_forward(student, jnp.asarray(g), jnp.asarray(l),
                                   J_VIT)
        return jd.dino_loss(s_out, jax.lax.stop_gradient(t_out),
                            jnp.asarray(center), J_CFG.ncrops,
                            jnp.float32(temp), J_CFG.student_temp)

    loss, grads = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, jstate.student))
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


@pytest.fixture(scope="module")
def jstep():
    return jax.jit(jd.make_dino_train_step(J_VIT, J_CFG))


@pytest.fixture(scope="module")
def first_grads(jstate, crops):
    """tpu_ac's gradients at the initial state (center 0, temp 0.04): the
    first step's, which decide where Adam's sign swing applies."""
    return _jgrads(jstate, *crops, jstate.center, 0.04)[1]


def _assert_states_close(got, want, n_steps, grads):
    got, want = _flat(td.dino_state_to_numpy(got)), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        a, b = got[k].copy(), want[k].copy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        part, _, name = k.partition("/")
        if part in ("student", "teacher"):
            near_eps = np.abs(grads[name]) < 1e-6
            np.testing.assert_allclose(a[near_eps], b[near_eps], rtol=0,
                                       atol=2 * LR * n_steps, err_msg=k)
            a[near_eps] = b[near_eps] = 0
        if k.startswith("nu/"):  # squares: 2x the gradients' gaps
            np.testing.assert_allclose(a, b, rtol=1e-4,
                                       atol=1e-5 * np.abs(b).max(),
                                       err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-6, err_msg=k)


def test_init_state_bit_identical(jstate):
    got = _flat(td.dino_state_to_numpy(
        td.init_dino_state(0, T_VIT, T_CFG, device="cpu")))
    want = _flat(jstate)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


def test_state_numpy_round_trip(jstate):
    back = _flat(td.dino_state_to_numpy(_tstate(jstate)))
    for k, v in _flat(jstate).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_loss_and_grads_match_value_and_grad(jstate, crops):
    g, l = crops
    center = np.random.default_rng(5).standard_normal(
        (1, CFG_KW["out_dim"])).astype(np.float32) * 0.1
    temp = 0.04
    jl, jg = _jgrads(jstate, g, l, center, temp)
    state = _tstate(jstate)._replace(center=torch.from_numpy(center))
    model = td.build_dino_model(T_VIT, T_CFG)
    loss, t_out, grads = td.dino_loss_and_grads(
        model, state, torch.from_numpy(g), torch.from_numpy(l),
        torch.tensor(temp), T_CFG)
    np.testing.assert_allclose(float(loss), jl, rtol=1e-5)
    assert t_out.shape == (2 * B, CFG_KW["out_dim"])
    assert grads.keys() == jg.keys()
    for k, want in jg.items():
        gap = np.linalg.norm(grads[k].numpy() - want)
        assert gap <= 1e-5 * np.linalg.norm(want) + 1e-12, (k, gap)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_state_after_steps_matches_tpu_ac(jstate, crops, jstep, first_grads,
                                          n_steps):
    """Step 1 runs in the frozen epoch: the last layer's moments advance
    with zero gradients and the parameters stay."""
    g, l = crops
    tstep = td.make_dino_train_step(T_VIT, T_CFG)
    js, ts = jax.tree.map(jnp.asarray, jstate), _tstate(jstate)
    for i in range(n_steps):
        frozen = i == 1
        prev = ts
        js, jm = jstep(js, jnp.asarray(g), jnp.asarray(l),
                       **_jscalars(frozen))
        ts, tm = tstep(ts, torch.from_numpy(g), torch.from_numpy(l),
                       **_scalars(frozen))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        if frozen:
            for k in ("head.last_layer.weight_v", "head.last_layer.weight_g"):
                assert torch.equal(ts.student[k], prev.student[k])
                assert not torch.equal(ts.opt_state.mu[k],
                                       prev.opt_state.mu[k])
    _assert_states_close(ts, jax.tree.map(np.asarray, js), n_steps,
                         first_grads)
    assert int(ts.step) == n_steps and int(ts.opt_state.count) == n_steps


def test_step_leaves_its_input_unchanged(jstate, crops):
    g, l = crops
    state = _tstate(jstate)
    before = _flat(td.dino_state_to_numpy(state))
    td.make_dino_train_step(T_VIT, T_CFG)(
        state, torch.from_numpy(g), torch.from_numpy(l), **_scalars())
    after = _flat(td.dino_state_to_numpy(state))
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)


def test_schedules_equal_tpu_ac():
    for bs in (64, 1024):
        want = jd.make_schedules(J_CFG, bs)
        got = td.make_schedules(T_CFG, bs)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype
    np.testing.assert_array_equal(td.cosine_scheduler(1.0, 0.1, 100, 10),
                                  jd.cosine_scheduler(1.0, 0.1, 100, 10))
    sch = td.make_schedules(T_CFG, 64)
    got = td.make_step_schedule_tables(T_CFG, sch, device="cpu")
    want = jd.make_step_schedule_tables(J_CFG, sch)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_tables_equal_host_scalars(jstate, crops):
    """Six steps across the epoch boundary (the freeze flips), the tables
    indexed on the device against the host's scalars: equal."""
    g, l = (torch.from_numpy(a) for a in crops)
    sch = td.make_schedules(T_CFG, 64)
    tab = td.make_step_schedule_tables(T_CFG, sch, device="cpu")
    host = td.make_dino_train_step(T_VIT, T_CFG)
    res = td.make_dino_train_step(T_VIT, T_CFG, resident_schedules=True)
    s_h = s_r = _tstate(jstate)
    spe = T_CFG.steps_per_epoch
    for it in range(6):
        epoch = it // spe
        s_h, m_h = host(s_h, g, l, lr=sch["lr"][it], wd=sch["wd"][it],
                        teacher_momentum=sch["momentum"][it],
                        teacher_temp=sch["teacher_temp"][epoch],
                        freeze_last=epoch < T_CFG.freeze_last_layer)
        s_r, m_r = res(s_r, g, l, tab)
        for k in ("loss", "lr", "wd"):
            assert torch.equal(m_h[k], m_r[k]), (it, k)
    for k, v in _flat(td.dino_state_to_numpy(s_h)).items():
        np.testing.assert_array_equal(
            _flat(td.dino_state_to_numpy(s_r))[k], v, err_msg=k)


def test_resident_step_clamps_past_total_steps(jstate, crops):
    g, l = (torch.from_numpy(a) for a in crops)
    sch = td.make_schedules(T_CFG, 64)
    tab = td.make_step_schedule_tables(T_CFG, sch, device="cpu")
    s = _tstate(jstate)._replace(
        step=torch.tensor(T_CFG.total_steps + 3, dtype=torch.int32))
    _, m = td.make_dino_train_step(T_VIT, T_CFG, resident_schedules=True)(
        s, g, l, tab)
    assert float(m["lr"]) == float(np.float32(sch["lr"][-1]))


def test_multi_step_equals_sequential(jstate):
    rng = np.random.default_rng(7)
    gs = torch.from_numpy(rng.standard_normal(
        (3, 2 * B, 3, 32, 32)).astype(np.float32))
    ls = torch.from_numpy(rng.standard_normal(
        (3, 2 * B, 3, 16, 16)).astype(np.float32))
    sch = td.make_schedules(T_CFG, 64)
    tab = td.make_step_schedule_tables(T_CFG, sch, device="cpu")
    step = td.make_dino_train_step(T_VIT, T_CFG, resident_schedules=True)
    s_seq = _tstate(jstate)
    losses = []
    for i in range(3):
        s_seq, m = step(s_seq, gs[i], ls[i], tab)
        losses.append(m["loss"])
    s_multi, ms = td.make_dino_multi_step(T_VIT, T_CFG, k=3)(
        _tstate(jstate), gs, ls, tab)
    assert ms["loss"].shape == (3,)
    assert torch.equal(ms["loss"], torch.stack(losses))
    np.testing.assert_array_equal(ms["lr"].numpy(), sch["lr"][:3])
    for k, v in _flat(td.dino_state_to_numpy(s_seq)).items():
        np.testing.assert_array_equal(
            _flat(td.dino_state_to_numpy(s_multi))[k], v, err_msg=k)
    with pytest.raises(ValueError):
        td.make_dino_multi_step(T_VIT, T_CFG, k=0)


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_equals_plain(jstate, crops, remat):
    g, l = (torch.from_numpy(a) for a in crops)
    plain = td.make_dino_train_step(T_VIT, T_CFG)
    rem = td.make_dino_train_step(
        T_VIT, dataclasses.replace(T_CFG, remat=remat))
    sp, mp = plain(_tstate(jstate), g, l, **_scalars())
    sr, mr = rem(_tstate(jstate), g, l, **_scalars())
    assert torch.equal(mp["loss"], mr["loss"])
    for k, v in sp.student.items():
        assert torch.equal(sr.student[k], v), k


def test_remat_recomputes_in_the_backward():
    """remat=True runs every block's forward again in the backward, its
    linears included; "dots" keeps the linears' outputs (no mm/addmm
    again) and recomputes the rest (the GELUs run again)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "gelu": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (aten.mm.default, aten.addmm.default):
                self.n["mm"] += 1
            elif func is aten.gelu.default:
                self.n["gelu"] += 1
            return func(*args, **(kwargs or {}))

    params = td.init_dino_state(0, T_VIT, T_CFG, device="cpu").student
    model = td.build_dino_model(T_VIT, T_CFG)
    x = torch.randn(2 * B, 3, 32, 32)

    def counts(remat):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        with model.bound(leaves), Count() as c:
            model(x, remat=remat).sum().backward()
        return c.n

    plain, dots, full = counts(False), counts("dots"), counts(True)
    depth = VIT_KW["depth"]
    # each block's GELU runs again; the linears too, but for fc2, whose
    # output the backward does not need (the recompute stops early)
    assert full["mm"] == plain["mm"] + 3 * depth
    assert dots["mm"] == plain["mm"]
    assert full["gelu"] == dots["gelu"] == plain["gelu"] + depth


def test_uint8_crops_equal_host_normalized(jstate):
    rng = np.random.default_rng(3)
    g8 = rng.integers(0, 256, (2 * B, 3, 32, 32), dtype=np.uint8)
    l8 = rng.integers(0, 256, (2 * B, 3, 16, 16), dtype=np.uint8)

    def host_norm(a):  # augment.to_normalized_array's f32 math, NCHW
        mean = IMAGENET_MEAN.reshape(3, 1, 1)
        std = IMAGENET_STD.reshape(3, 1, 1)
        return torch.from_numpy((a.astype(np.float32) / 255.0 - mean) / std)

    step = td.make_dino_train_step(T_VIT, T_CFG)
    s8, m8 = step(_tstate(jstate), torch.from_numpy(g8),
                  torch.from_numpy(l8), **_scalars())
    sf, mf = step(_tstate(jstate), host_norm(g8), host_norm(l8),
                  **_scalars())
    assert torch.equal(m8["loss"], mf["loss"])
    for k, v in sf.student.items():
        assert torch.equal(s8.student[k], v), k


def test_bf16_close_to_f32(jstate, crops):
    g, l = (torch.from_numpy(a) for a in crops)
    s32, m32 = td.make_dino_train_step(T_VIT, T_CFG)(
        _tstate(jstate), g, l, **_scalars())
    s16, m16 = td.make_dino_train_step(
        T_VIT, T_CFG, compute_dtype=torch.bfloat16)(
        _tstate(jstate), g, l, **_scalars())
    assert np.isfinite(float(m16["loss"]))
    assert abs(float(m16["loss"]) - float(m32["loss"])) < 0.05
    for part in (s16.student, s16.teacher, s16.opt_state.mu):
        assert all(v.dtype == torch.float32 for v in part.values())
    assert s16.center.dtype == torch.float32


def test_bound_rejects_wrong_params():
    model = td.build_dino_model(T_VIT, T_CFG)
    params = td.init_dino_state(0, T_VIT, T_CFG, device="cpu").student
    params.pop("head.last_layer.weight_g")
    with pytest.raises(KeyError, match="weight_g"):
        with model.bound(params):
            pass
    # the module is left as it was
    assert model.head.last_layer.weight_g.is_meta


def test_init_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        td.init_dino_state(0, T_VIT, T_CFG)
