"""AdaLoRA's rank allocation in the port (neuspeech1_tpu_torch/models/
lora.py) against the JAX package's on the same adapter trees (carried
across with `lora_from_params`), in f32 on the CPU: the importance EMAs and
triplet scores within rtol 1e-5, budgets and mask_ind exactly over PEFT's
schedule grid, masks exactly from identical scores, the orthogonality loss
and its gradients within rtol 1e-4 / atol 2e-4, and pruned ranks that
revive."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuspeech1_tpu.models import lora as jl
from neuspeech1_tpu_torch.models import lora as tl
from neuspeech1_tpu_torch.models.convert import lora_from_params
from tests.test_torch_whisper import port, tiny

torch.set_num_threads(1)

EMA_RTOL = 1e-5
RTOL, ATOL = 1e-4, 2e-4
RANK = 4


def _jax_lora(seed=1):
    """A stacked AdaLoRA tree on encoder and decoder, E drawn nonzero."""
    config = tiny()
    lora = jax.device_get(jl.init_lora(
        jax.random.key(seed), config, rank=RANK, alpha=8.0,
        parts=("encoder", "decoder"), adalora=True))
    rng = np.random.default_rng(seed)

    def f(path, x):
        if path[-1].key == "E":
            return rng.standard_normal(x.shape).astype(np.float32)
        return np.asarray(x)

    return jax.tree_util.tree_map_with_path(f, lora)


def _grads_like(lora, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: rng.standard_normal(np.shape(x)).astype(np.float32), lora)


def _port_grads(jgrads):
    """The JAX gradient tree as the port's {entry path: {A, B, E}}."""
    tg = lora_from_params(jgrads, device="cpu")
    return {p: {n: e[n] for n in tl.IPT_NAMES}
            for p, e in tl.adalora_entries(tg)}


def _stacked(by_path, t_lora, name=None):
    """A {entry path: tensor or {name: tensor}} map as the JAX tree's
    stacked leaves, keyed by the entry's path without the layer index."""
    out = {}
    for path, _ in tl.adalora_entries(t_lora):
        key = "/".join(p for p in path.split("/") if not p.isdigit())
        v = by_path[path] if name is None else by_path[path][name]
        out.setdefault(key, []).append(v.detach().numpy())
    return {k: np.stack(v) for k, v in out.items()}


def _jax_by_key(tree):
    """The JAX tree's entries ({A, B, ...} dicts or [L, r] arrays) by path
    without the stacking: ``encoder/layers/self_attn/q``."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            p = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict) and not ("A" in v or "E" in v):
                walk(v, p)
            else:
                out[p] = v

    walk(tree, "")
    return out


@pytest.fixture(scope="module")
def ema_runs():
    """Three importance updates in each package on the same trees."""
    jlora = _jax_lora()
    t_lora = lora_from_params(jlora, device="cpu")
    jipt = jl.adalora_ipt_init(jlora)
    tipt = tl.adalora_ipt_init(t_lora)
    for s in range(3):
        g = _grads_like(jlora, 10 + s)
        jipt = jl.adalora_ipt_update(jipt, jlora, g)
        tl.adalora_ipt_update(tipt, t_lora, _port_grads(g))
    return jlora, t_lora, jipt, tipt


@pytest.mark.parametrize("which", ["avg", "unc"])
@pytest.mark.parametrize("name", ["A", "B", "E"])
def test_importance_emas_match_jax(ema_runs, which, name):
    jlora, t_lora, jipt, tipt = ema_runs
    got = _stacked(tipt[which], t_lora, name)
    ref = {k: np.asarray(v[name])
           for k, v in _jax_by_key(jipt[which]).items()}
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=EMA_RTOL, atol=0,
                                   err_msg=k)
        assert np.abs(ref[k]).max() > 0


def test_triplet_scores_match_jax(ema_runs):
    _, t_lora, jipt, tipt = ema_runs
    got = _stacked(tl.adalora_triplet_scores(tipt), t_lora)
    ref = {k: np.asarray(v) for k, v in
           _jax_by_key(jl.adalora_triplet_scores(jipt)).items()}
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=EMA_RTOL, atol=0,
                                   err_msg=k)


def test_rank_and_matrix_counts_match_jax():
    jlora = _jax_lora()
    t_lora = lora_from_params(jlora, device="cpu")
    assert tl.adalora_total_ranks(t_lora) == jl.adalora_total_ranks(jlora)
    assert tl.adalora_matrix_count(t_lora) == jl.adalora_matrix_count(jlora)
    # encoder and decoder, 2 layers each, 6 matrices each, rank 4
    assert jl.adalora_matrix_count(jlora) == 24
    assert jl.adalora_total_ranks(jlora) == 24 * RANK


# PEFT's grid (tests/test_trainer.py::test_adalora_budget_matches_peft)
STEPS = [0, 1, 199, 200, 201, 2000, 4600, 8999, 9000, 9001, 10000]


@pytest.mark.parametrize("step", STEPS)
def test_budget_schedule_matches_jax(step):
    for delta_t in (10, 7):
        assert tl.adalora_budget_schedule(step, 120, 40, 200, 1000, 10000,
                                          delta_t) == \
            jl.adalora_budget_schedule(step, 120, 40, 200, 1000, 10000,
                                       delta_t)
    assert tl.adalora_budget(step, 12, 4, 200, 1000, 10000) == \
        jl.adalora_budget(step, 12, 4, 200, 1000, 10000)


def _scores(jlora, seed, ties: bool):
    """Per-entry [L, r] scores drawn from numpy; with ``ties`` on a coarse
    grid, so that many ranks share the threshold's value."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict) and "E" in v:
                s = rng.standard_normal(v["E"].shape[:2]).astype(np.float32)
                out[k] = np.round(s * 2) / 2 if ties else s
            elif isinstance(v, dict):
                out[k] = walk(v)
        return out

    return walk(jlora)


def _port_scores(t_lora, jscores):
    """The JAX [L, r] scores as the port's {entry path: [r]}."""
    by_key = _jax_by_key(jscores)
    out = {}
    for path, _ in tl.adalora_entries(t_lora):
        parts = path.split("/")
        layer = next(int(p) for p in parts if p.isdigit())
        key = "/".join(p for p in parts if not p.isdigit())
        out[path] = torch.from_numpy(np.asarray(by_key[key][layer]))
    return out


def _assert_same_entries(t_lora, jtree, names=("E", "mask")):
    got = {}
    for path, e in tl.adalora_entries(t_lora):
        got[path] = e
    for name in names:
        s = _stacked({p: e[name] for p, e in got.items()}, t_lora)
        ref = {k: np.asarray(v[name]) for k, v in _jax_by_key(jtree).items()
               if isinstance(v, dict)}
        for k in ref:
            np.testing.assert_array_equal(s[k], ref[k], err_msg=f"{k}/{name}")


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("budget", [95, 60, 24, 1])
def test_mask_to_budget_matches_jax(budget, ties):
    """Identical scores give identical masks and E, exactly; the kept
    count is init_bgt - k unless ties sit at the threshold."""
    jlora = _jax_lora()
    t_lora = lora_from_params(jlora, device="cpu")
    jscores = _scores(jlora, 4, ties)
    jnew = jax.device_get(jl.adalora_mask_to_budget(jlora, jscores, budget))
    tl.adalora_mask_to_budget(t_lora, _port_scores(t_lora, jscores), budget)
    _assert_same_entries(t_lora, jnew)
    kept = sum(int(e["mask"].sum()) for _, e in tl.adalora_entries(t_lora))
    if not ties:
        assert kept == budget


def test_update_masks_global_matches_jax():
    jlora = _jax_lora()
    t_lora = lora_from_params(jlora, device="cpu")
    jscores = _scores(jlora, 5, ties=False)
    jnew = jax.device_get(jl.adalora_update_masks_global(jlora, jscores, 2))
    tl.adalora_update_masks_global(t_lora, _port_scores(t_lora, jscores), 2)
    _assert_same_entries(t_lora, jnew)


def test_masking_keeps_the_tensors():
    """Masking writes E and mask in place: the optimizer's references stay
    valid."""
    t_lora = lora_from_params(_jax_lora(), device="cpu")
    before = {p: (e["E"], e["mask"]) for p, e in tl.adalora_entries(t_lora)}
    scores = {p: torch.arange(RANK, dtype=torch.float32)
              for p in before}
    tl.adalora_mask_to_budget(t_lora, scores, 24)
    for p, e in tl.adalora_entries(t_lora):
        assert e["E"] is before[p][0] and e["mask"] is before[p][1]
        assert e["mask"][:, 0].tolist() == [0.0, 0.0, 0.0, 1.0]


def test_apply_pattern_and_pattern_of_match_jax():
    jlora = _jax_lora()
    t_lora = lora_from_params(jlora, device="cpu")
    jscores = _scores(jlora, 6, ties=False)
    jmasked = jax.device_get(jl.adalora_mask_to_budget(jlora, jscores, 40))
    tl.adalora_mask_to_budget(t_lora, _port_scores(t_lora, jscores), 40)
    jpat = jl.adalora_pattern_of(jmasked)
    tpat = tl.adalora_pattern_of(t_lora)
    # E regrows on the pruned ranks; re-applying the pattern zeroes it
    grown = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.5 if p[-1].key == "E" else x, jmasked)
    with torch.no_grad():
        for _, e in tl.adalora_entries(t_lora):
            e["E"].add_(0.5)
    jnew = jax.device_get(jl.adalora_apply_pattern(grown, jpat))
    tl.adalora_apply_pattern(t_lora, tpat)
    _assert_same_entries(t_lora, jnew)


def test_orth_loss_and_grads_match_jax():
    jlora = _jax_lora()
    t_lora = lora_from_params(jlora, device="cpu")
    ref, jg = jax.value_and_grad(jl.adalora_orth_loss)(
        jax.tree_util.tree_map(jnp.asarray, jlora))
    leaves = []
    for _, e in tl.adalora_entries(t_lora):
        for n in ("A", "B"):
            e[n].requires_grad_(True)
            leaves.append(e[n])
    got = tl.adalora_orth_loss(t_lora)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL, atol=ATOL)
    for name in ("A", "B"):
        g = _stacked({p: e[name].grad for p, e in
                      tl.adalora_entries(t_lora)}, t_lora)
        r = {k: np.asarray(v[name]) for k, v in
             _jax_by_key(jax.device_get(jg)).items() if isinstance(v, dict)}
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k}/{name}")


def test_orth_loss_is_zero_without_adalora():
    config = port(tiny())
    plain = tl.init_lora(config, rank=RANK, device="cpu")
    assert float(tl.adalora_orth_loss(plain)) == 0.0
    assert float(jl.adalora_orth_loss(jax.device_get(jl.init_lora(
        jax.random.key(0), tiny(), rank=RANK)))) == 0.0


def test_pruned_ranks_can_revive():
    """The mask gates nothing in the forward: a pruned rank whose E regrows
    contributes again, and its E keeps a gradient
    (tests/test_adalora_peft_parity.py::test_pruned_ranks_can_revive)."""
    entry = {"A": torch.ones(2, 3), "B": torch.ones(3, 4),
             "E": torch.tensor([[1.0], [0.0], [1.0]]),
             "mask": torch.tensor([[1.0], [0.0], [1.0]]),
             "alpha": torch.full((1, 1), 3.0)}
    x = torch.ones(1, 2)
    base = tl.lora_delta(x, entry)
    revived = dict(entry, E=torch.tensor([[1.0], [0.5], [1.0]]))
    assert not torch.allclose(base, tl.lora_delta(x, revived))
    e = entry["E"].clone().requires_grad_(True)
    tl.lora_delta(x, dict(entry, E=e)).sum().backward()
    assert float(e.grad[1, 0]) != 0.0
    jentry = {k: jnp.asarray(v.numpy()) for k, v in entry.items()}
    jentry["alpha"] = jnp.asarray(3.0)
    np.testing.assert_allclose(
        base.numpy(), np.asarray(jl.lora_delta(jnp.ones((1, 2)), jentry)),
        rtol=RTOL, atol=ATOL)
