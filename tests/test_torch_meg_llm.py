"""The EEG tower before a DeepSeek-V3-style language model
(``models/meg_lm.py``, ``models/moe_lm.py``, ``ops/moe_gemm.py``) against
the benchmark's plain float32 reference (``benchmark/reference/
meg_llm.py``) at a tiny size on the CPU, in f32: logits, loss and the
gradients of the stem, the adapters and the projector; the router's
selection and weights, interleaved RoPE, the causal prefix, ignored pads,
the grouped GEMM's plain path, the experts' backward, and the frozen
language model in the training step."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.kinds.llm_train_step import meg_lm_config
from benchmark.lib import llm_inputs, weights
from benchmark.reference import meg_llm as ref
from benchmark.reference import model as ref_model
from benchmark.tests import tiny_llm
from neuspeech1_tpu_torch.config import MegLMConfig, MoELMConfig
from neuspeech1_tpu_torch.models import meg_lm, moe_lm
from neuspeech1_tpu_torch.models import whisper as tw
from neuspeech1_tpu_torch.ops import moe_gemm
from neuspeech1_tpu_torch.train import optimizer, profiling, trainstep

SEED = 2 ** 31 + 5
CPU = torch.device("cpu")


def _inputs(c, seed=SEED):
    """(model, lora, feats f32 [4, ch, S], labels, inputs) of the tiny
    configuration: the program's model in f32 from the seed's weights."""
    tr = tiny_llm.traffic()
    t = llm_inputs.tower(c)
    model = meg_lm.module_from_weights(
        weights.param_tree(t, seed, CPU)["encoder"],
        llm_inputs.projector_tree(c, seed, CPU),
        llm_inputs.lm_state(c, seed, CPU, torch.float32),
        meg_lm_config(c), device=CPU, dtype=torch.float32)
    lora = weights.adapter_tree(t, seed, CPU)
    feats, labels, inputs = llm_inputs.pool(c, tr, seed, CPU)
    return model, lora, feats[:4].float(), labels[:4], inputs[:4]


def _reference(c, seed=SEED):
    t = llm_inputs.tower(c)
    return (weights.param_tree(t, seed, CPU), weights.adapter_tree(t, seed, CPU),
            llm_inputs.projector_tree(c, seed, CPU),
            llm_inputs.lm_state(c, seed, CPU, torch.float32))


def _program_leaves(model, lora):
    leaves = optimizer.named_leaves(model, lora)
    return {k: v for k, v in leaves.items()
            if meg_lm.trainable_pred()(k) and k.rsplit("/", 1)[-1]
            not in ("alpha", "mask")}


def test_logits_loss_and_gradients_match_the_reference():
    c = tiny_llm.config()
    model, lora, feats, labels, inputs = _inputs(c)
    leaves = _program_leaves(model, lora)
    for v in leaves.values():
        v.requires_grad_(True)
    logits = meg_lm.forward(model, feats, inputs, lora)
    loss = tw.ce_loss(logits, labels)
    loss.backward()

    tree, rlora, proj, lm = _reference(c)
    rleaves = ref.trainable(tree, rlora, proj)
    for v in rleaves.values():
        v.requires_grad_(True)
    rlogits = ref.logits(tree, rlora, proj, lm, c, feats, inputs)
    n = int((labels != -100).sum())
    rloss = ref.cross_entropy(rlogits, labels, n)
    rloss.backward()

    assert logits.shape == (4, labels.shape[1], c["vocab_size"])
    torch.testing.assert_close(logits, rlogits, rtol=1e-4, atol=1e-5)
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    assert set(leaves) == set(rleaves)
    assert any(k.startswith("model/projector/") for k in leaves)
    for k, v in leaves.items():
        g, rg = v.grad, rleaves[k].grad
        g = g.T if k.endswith("/w") and "projector" in k else g
        torch.testing.assert_close(g.reshape(rg.shape), rg, rtol=1e-3,
                                   atol=1e-6, msg=k)


def test_blockwise_replay_gradients_equal_the_whole_backward():
    """The reference's card path (rows in blocks, the language model's
    backward a layer at a time) against autograd through the whole model."""
    c = tiny_llm.config()
    _, _, feats, labels, inputs = _inputs(c)
    n = int((labels != -100).sum())
    grads = []
    for blockwise in (False, True):
        tree, rlora, proj, lm = _reference(c)
        leaves = ref.trainable(tree, rlora, proj)
        for v in leaves.values():
            v.requires_grad_(True)
        if blockwise:
            ref.loss_and_grads(tree, rlora, proj, lm, c, feats, labels,
                               inputs, rows=2)
        else:
            lg = ref.logits(tree, rlora, proj, lm, c, feats, inputs)
            loss = ref.cross_entropy(lg, labels, n)
            weight = llm_inputs.tower(c)["adapters"]["orth_reg_weight"]
            (loss + weight * ref_model.orthogonality(rlora)).backward()
        grads.append({k: v.grad for k, v in leaves.items()})
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=1e-4, atol=1e-7,
                                   msg=k)


def test_selection_by_biased_score_weights_by_unbiased():
    """noaux_tc: the top-k of score + bias is chosen, the weights are the
    chosen experts' unbiased scores over their sum, times the routed
    scaling factor."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]])
    gate_w = torch.eye(4)
    bias = torch.tensor([0.0, 0.0, 0.5, 0.0])
    idx, w = moe_lm.select(logits, gate_w, bias, top_k=2, norm_topk=True,
                           scale=2.446)
    scores = torch.sigmoid(logits[0])
    # unbiased the top two would be experts 0 and 1; the bias lifts 2
    # (0.5 + 0.5) over 1 (0.731)
    assert sorted(idx[0].tolist()) == [0, 2]
    order = idx[0].tolist()
    expect = scores[order] / scores[order].sum() * 2.446
    torch.testing.assert_close(w[0], expect)
    p = {"mlp.gate.weight": gate_w, "mlp.gate.e_score_correction_bias": bias}
    c = {"num_experts_per_tok": 2, "norm_topk_prob": True,
         "routed_scaling_factor": 2.446}
    ref_idx, ref_w, gap, miss = ref.select(logits, p, c)
    got = dict(zip(idx[0].tolist(), w[0].tolist()))
    want = dict(zip(ref_idx[0].tolist(), ref_w[0].tolist()))
    assert got.keys() == want.keys() and gap == 0.0 and miss == 0
    assert got == pytest.approx(want)
    # the reference following given choices: weighted by its own unbiased
    # scores, read by how far the worst lies below its k-th best biased
    # score; fewer than k choices count as the worst-scored expert. A
    # token misses where its choices are not the reference's own top k
    biased = scores + bias
    _, fw, gap, miss = ref.select(logits, p, c,
                                  forced=torch.tensor([[0, 1]]))
    assert gap == pytest.approx(float(biased[0] - biased[1])) and miss == 1
    torch.testing.assert_close(fw[0], scores[:2] / scores[:2].sum() * 2.446)
    _, _, gap, miss = ref.select(logits, p, c, forced=torch.tensor([[2, 0]]))
    assert gap == 0.0 and miss == 0
    _, _, gap, miss = ref.select(logits, p, c, forced=torch.tensor([[0]]))
    assert gap == pytest.approx(float(biased[0] - biased[3])) and miss == 1


def test_rope_rotates_adjacent_pairs():
    c = MoELMConfig(qk_rope_head_dim=8, rope_theta=10000.0)
    t, d = 5, 8
    x = torch.randn(2, t, 3, d, generator=torch.Generator().manual_seed(0))
    cos, sin = moe_lm.rope_tables(c, t, CPU, torch.float32)
    out = moe_lm.apply_rope(x, cos, sin)
    for pos in range(t):
        for i in range(d // 2):
            ang = pos * 10000.0 ** (-2 * i / d)
            a, b = x[:, pos, :, 2 * i], x[:, pos, :, 2 * i + 1]
            # pair i lands at dims i and i + d/2 (the published layout)
            torch.testing.assert_close(
                out[:, pos, :, i], a * np.cos(ang) - b * np.sin(ang))
            torch.testing.assert_close(
                out[:, pos, :, i + d // 2], b * np.cos(ang) + a * np.sin(ang))
    rc, rs = ref.rope_tables({"qk_rope_head_dim": d, "rope_theta": 10000.0},
                             t, CPU)
    torch.testing.assert_close(ref.apply_rope(x, rc, rs), out)


def test_causal_over_prefix_and_text():
    """A text position's logits see the prefix and the tokens before it,
    never those after it."""
    c = tiny_llm.config()
    model, lora, feats, labels, inputs = _inputs(c)
    with torch.no_grad():
        base = meg_lm.forward(model, feats, inputs, lora)
        later = inputs.clone()
        later[:, 6:] = (later[:, 6:] + 1) % c["vocab_size"]
        moved = meg_lm.forward(model, feats, later, lora)
        torch.testing.assert_close(moved[:, :6], base[:, :6])
        assert not torch.allclose(moved[:, 6:], base[:, 6:])
        other = meg_lm.forward(model, feats.flip(0), inputs, lora)
        assert not torch.allclose(other[:, 0], base[:, 0])


def test_pads_are_ignored():
    """-100 labels add nothing to the loss, and -100 inputs read as the
    pad id."""
    c = tiny_llm.config()
    model, lora, feats, labels, inputs = _inputs(c)
    assert (labels == -100).any()
    with torch.no_grad():
        logits = meg_lm.forward(model, feats, inputs, lora)
        loss = tw.ce_loss(logits, labels)
        keep = labels != -100
        logp = logits.log_softmax(-1)
        picked = logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
        assert float(loss) == pytest.approx(float(-picked[keep].mean()),
                                            rel=1e-5)
        raw = torch.where(inputs == c["pad_id"], -100, inputs)
        torch.testing.assert_close(meg_lm.forward(model, feats, raw, lora),
                                   logits)


@pytest.mark.parametrize("trans_w", [False, True])
def test_grouped_gemm_plain_matches_a_loop_over_rows(trans_w):
    """Empty and uneven groups: each row times its own expert's weight."""
    gen = torch.Generator().manual_seed(3)
    counts = torch.tensor([0, 5, 1, 0, 12, 0, 3, 0])
    offs = torch.cat([torch.zeros(1, dtype=torch.long), counts.cumsum(0)])
    k, n = 16, 24
    x = torch.randn(int(offs[-1]), k, generator=gen)
    w = torch.randn(8, n, k, generator=gen) if trans_w else \
        torch.randn(8, k, n, generator=gen)
    y = moe_gemm.grouped_gemm(x, w, offs.to(torch.int32), trans_w)
    expert = torch.repeat_interleave(torch.arange(8), counts)
    we = w[expert].transpose(1, 2) if trans_w else w[expert]
    torch.testing.assert_close(y, torch.bmm(x[:, None], we)[:, 0])
    with pytest.raises(ValueError):
        moe_gemm.grouped_gemm(x, w, offs[:-1].to(torch.int32), trans_w)


def test_grouped_experts_backward_equals_autograd():
    gen = torch.Generator().manual_seed(4)
    counts = torch.tensor([3, 0, 7, 2])
    offs = torch.cat([torch.zeros(1, dtype=torch.long),
                      counts.cumsum(0)]).to(torch.int32)
    d, width = 8, 6
    x = torch.randn(12, d, generator=gen, requires_grad=True)
    gu = torch.randn(4, d, 2 * width, generator=gen)
    down = torch.randn(4, width, d, generator=gen)
    dy = torch.randn(12, d, generator=gen)
    moe_lm.GroupedExperts.apply(x, offs, gu, down).backward(dy)
    x2 = x.detach().clone().requires_grad_(True)
    expert = torch.repeat_interleave(torch.arange(4), counts)
    h = torch.bmm(x2[:, None], gu[expert])[:, 0]
    g, u = h.chunk(2, dim=-1)
    out = torch.bmm((torch.nn.functional.silu(g) * u)[:, None],
                    down[expert])[:, 0]
    out.backward(dy)
    torch.testing.assert_close(x.grad, x2.grad)


def test_dispatch_and_combine_equal_autograd_through_indexing():
    gen = torch.Generator().manual_seed(5)
    idx = torch.randint(0, 6, (7, 3), generator=gen)
    r = moe_lm.route(idx, 6)
    x = torch.randn(7, 5, generator=gen, requires_grad=True)
    w = torch.rand(7, 3, generator=gen, requires_grad=True)
    x2, w2 = (t.detach().clone().requires_grad_(True) for t in (x, w))
    dy = torch.randn(7, 5, generator=gen)
    moe_lm.Combine.apply(moe_lm.Dispatch.apply(x, r.token, r.inverse) * 2.0,
                         w, r.inverse, r.order).backward(dy)
    plain = ((x2[r.token] * 2.0)[r.inverse] * w2[..., None]).sum(1)
    plain.backward(dy)
    torch.testing.assert_close(x.grad, x2.grad)
    torch.testing.assert_close(w.grad, w2.grad)


def test_route_sorts_pairs_by_expert_and_counts_while_tracing():
    idx = torch.tensor([[2, 0], [2, 3], [0, 2]])
    r = moe_lm.route(idx, 5)
    assert r.offs.tolist() == [0, 2, 2, 5, 6, 6]
    flat = idx.reshape(-1)
    sorted_experts = flat[r.inverse.reshape(-1).argsort()]
    assert sorted_experts.tolist() == sorted(flat.tolist())
    assert (flat.view(3, 2) == idx).all()
    for t in range(3):
        for s in range(2):
            row = int(r.inverse[t, s])
            assert int(r.token[row]) == t
    before = profiling.counters()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        moe_lm.route(idx, 5)
    changes = profiling.counter_changes(before)
    assert changes["moe.rows"] == 6
    assert changes["moe.max_expert_rows"] == 3
    assert changes["moe.empty_experts"] == 2


def test_frozen_language_model_takes_no_state_and_stays():
    c = tiny_llm.config()
    model, lora, feats, labels, inputs = _inputs(c)
    config = meg_lm_config(c)
    tx = optimizer.make_optimizer(peak_lr=1e-3, warmup_steps=0,
                                  total_steps=10)
    state, frozen = trainstep.init_train_state(model, lora, tx)
    assert state.trainable and not any(
        k.startswith("model/lm/") for k in state.trainable)
    assert not any(k.startswith("model/lm/") for k in state.opt_state.mu)
    assert any(k.startswith("model/projector/") for k in state.trainable)
    lm_before = {k: v.clone() for k, v in model.lm.state_dict().items()}
    proj_before = model.projector.fc1.weight.clone()
    step = trainstep.make_train_step(config, config.stem, tx,
                                     orth_reg_weight=0.5, fold_lora=True,
                                     track_adalora_importance=True)
    out = step(state, frozen, {"input_features": feats.to(torch.bfloat16),
                               "labels": labels,
                               "decoder_input_ids": inputs})
    assert torch.isfinite(out["loss"]) and float(out["grad_norm"]) > 0
    for k, v in model.lm.state_dict().items():
        assert torch.equal(v, lm_before[k]), k
        assert not v.requires_grad
    assert not torch.equal(model.projector.fc1.weight, proj_before)
    with pytest.raises(ValueError):
        trainstep.make_train_step(dataclasses.replace(config, pad_id=0),
                                  config.stem, tx)(state, frozen, {})


def test_configs_reject_what_they_do_not_implement():
    with pytest.raises(ValueError):
        MoELMConfig(topk_method="greedy")
    with pytest.raises(ValueError):
        MoELMConfig(scoring_func="softmax")
    with pytest.raises(ValueError):
        MoELMConfig(n_group=8, topk_group=4)
    with pytest.raises(ValueError):
        MegLMConfig(pad_id=MoELMConfig().vocab_size)
    m = MegLMConfig()
    assert m.lm.qk_head_dim == 192
    assert [m.lm.is_moe_layer(i) for i in range(3)] == [False, True, True]
