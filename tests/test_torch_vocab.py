"""PyTorch port, the vocab-parallel embedding lookup, head and
cross-entropy (``parallel.vocab``) against the whole-table ops and the
JAX package, float32, atol = rtol = 1e-4.

* On 4 CPU ranks over gloo, in one spawn: the lookup, the NLL and the
  whole logits with their table and hidden-state gradients, in the
  same-rows form on groups of 2 and 4 ranks (the 'tp' axis, serving) and
  the rows-differ form on groups of 2 and 4 (the 'ep' axis in training),
  against the whole table's ``table[tokens]``, ``models.model.masked_nll``
  and ``h @ table.T`` on one process, and the JAX package's
  ``layers.embed`` and ``model.masked_ce`` on the same numpy inputs. The
  vocab (250) pads to 256, so the padded columns fall in the last shard
  of every split.
* In the same spawn, ``replicated_leaves`` and ``broadcast_params`` on an
  'ep'-split table: the ranks' vocab rows stay their own.
* On meta tensors, full size: Mula-100B-A7B on (dp 2, pp 4, ep 2) and
  Mula-220B-A10B on (dp 2, pp 8, ep 2, tp 2) with fsdp, the table
  elements and state bytes a rank with the split and with the tables
  whole.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.model import masked_nll, padded_vocab  # noqa: E402
from repro_torch.optim import epso as tepso  # noqa: E402
from repro_torch.parallel import ep_shard, replicated_leaves, spawn  # noqa: E402
from repro_torch.parallel.sharding import is_table_path, param_placements  # noqa: E402
from repro_torch.train.trainer import placements  # noqa: E402
from repro_torch.tree import leaves, leaves_with_path  # noqa: E402

import torch_ep_ranks as ranks  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
VOCAB, B, S = 250, 8, 5
CASES = (("same", 2), ("same", 4), ("differ", 2), ("differ", 4))
# full size, the plans PERF.md computes: (arch, {axis: size})
FULL_PLANS = (("mula-100b-a7b", {"data": 2, "pp": 4, "ep": 2}),
              ("mula-220b-a10b", {"data": 2, "pp": 8, "ep": 2, "tp": 2}))


def _cfgs():
    kw = dict(d_model=16, vocab=VOCAB, max_experts=8)
    return jreduced(jget("mula-7b-a1b"), **kw), treduced(tget("mula-7b-a1b"), **kw)


def _inputs(d, vp, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, VOCAB, size=(B, S))
    labels[rng.random((B, S)) < 0.2] = -1
    f32 = np.float32
    return {"table": rng.standard_normal((vp, d)).astype(f32),
            "tokens": rng.integers(0, VOCAB, size=(B, S)), "labels": labels,
            "h": rng.standard_normal((B, S, d)).astype(f32),
            "ct": rng.standard_normal((B, S, d)).astype(f32),
            "ctl": rng.standard_normal((B, S, vp)).astype(f32)}


def _whole(x, tc):
    """The whole table's lookup, NLL and logits on one process, with their
    gradients."""
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    table = t["table"].clone().requires_grad_()
    h = t["h"].clone().requires_grad_()
    emb = table[t["tokens"]]
    (g_embed,) = torch.autograd.grad((emb * t["ct"]).sum(), table)
    nll, count = masked_nll(h @ table.T, t["labels"], tc)
    g_table, g_h = torch.autograd.grad(nll, (table, h))
    logits = h @ table.T
    g_ltable, g_lh = torch.autograd.grad((logits * t["ctl"]).sum(), (table, h))
    return {"embed": emb.detach(), "g_embed": g_embed, "nll": nll.detach(), "count": count,
            "g_table": g_table, "g_h": g_h, "logits": logits.detach(), "g_ltable": g_ltable,
            "g_lh": g_lh}


def _jax(x, jc):
    """The JAX package's embedding and masked CE (its NLL sum), with their
    gradients."""
    table, h = jnp.asarray(x["table"]), jnp.asarray(x["h"])
    tokens, labels = jnp.asarray(x["tokens"]), jnp.asarray(x["labels"])

    def lookup(tb):
        return jnp.sum(jlayers.embed({"table": tb}, tokens, jnp.float32) * x["ct"])

    def nll(tb, hh):
        ce, ntok = jmodel.masked_ce(hh @ tb.T, labels, jc)
        return ce * ntok

    return {"embed": np.asarray(jlayers.embed({"table": table}, tokens, jnp.float32)),
            "g_embed": np.asarray(jax.grad(lookup)(table)),
            "nll": float(nll(table, h)),
            "g_table": np.asarray(jax.grad(nll, 0)(table, h)),
            "g_h": np.asarray(jax.grad(nll, 1)(table, h))}


@pytest.fixture(scope="module")
def vocab_runs():
    jc, tc = _cfgs()
    vp = padded_vocab(tc)
    assert vp == 256 and vp - VOCAB == 6
    x = _inputs(tc.d_model, vp)
    batch = {k: torch.from_numpy(x[k]) for k in ("tokens", "labels", "h", "ct", "ctl")}
    params = init_params(tc, seed=0, device="cpu")
    out = spawn(ranks.vocab_cases_rank, 4, device="cpu", timeout_s=120,
                args=(torch.from_numpy(x["table"]), batch, VOCAB, CASES, params))
    return {"x": x, "whole": _whole(x, tc), "jax": _jax(x, jc), "ranks": out,
            "params": params}


def test_whole_table_ops_match_jax(vocab_runs):
    """The one-process references of the cases below: the port's lookup and
    masked NLL of the whole table are the JAX package's, gradients too."""
    w, j = vocab_runs["whole"], vocab_runs["jax"]
    for k in ("embed", "g_embed", "g_table", "g_h"):
        np.testing.assert_allclose(w[k].numpy(), j[k], **TOL, err_msg=k)
    np.testing.assert_allclose(float(w["nll"]), j["nll"], **TOL)


@pytest.mark.parametrize("case", CASES, ids=[f"{f}{n}" for f, n in CASES])
def test_vocab_parallel_ops_match_the_whole_table(vocab_runs, case):
    """Every rank of every group: its rows' lookup bit for bit the whole
    table's; its tile's lookup gradient the whole gradient's rows (every
    row's tokens, in the rows-differ form through the reduce-scatter's
    backward); the NLL (the same-rows form: the whole batch's on every
    rank; rows that differ: the rank's share, the shares summing to the
    whole), its count and its gradients of the tile and of the rank's
    hidden states; the whole logits of the rank's rows and their
    gradients; each against the whole table's ops and the JAX package's."""
    form, n = case
    w, j = vocab_runs["whole"], vocab_runs["jax"]
    got = [r[case] for r in vocab_runs["ranks"]]
    for rank, r in enumerate(got):
        rows, cols = r["rows"], r["cols"]
        assert torch.equal(r["embed"], w["embed"][rows]), rank
        for k in ("g_embed", "g_table", "g_ltable"):
            np.testing.assert_allclose(r[k].numpy(), w[k][cols].numpy(), **TOL,
                                       err_msg=f"rank {rank} {k}")
        for k in ("g_embed", "g_table"):
            np.testing.assert_allclose(r[k].numpy(), j[k][cols], **TOL)
        for k, jk in (("g_h", "g_h"), ("g_lh", None)):
            np.testing.assert_allclose(r[k].numpy(), w[k][rows].numpy(), **TOL,
                                       err_msg=f"rank {rank} {k}")
            if jk:
                np.testing.assert_allclose(r[k].numpy(), j[jk][rows], **TOL)
        np.testing.assert_allclose(r["logits"].numpy(), w["logits"][rows].numpy(), **TOL)
        assert int(r["count"]) == int((vocab_runs["x"]["labels"][rows] >= 0).sum())
    shares = got[:n]
    total = sum(float(r["nll"]) for r in shares) if form == "differ" else float(got[0]["nll"])
    np.testing.assert_allclose(total, float(w["nll"]), **TOL)
    np.testing.assert_allclose(total, j["nll"], **TOL)
    if form == "same":
        assert all(torch.equal(r["nll"], got[0]["nll"]) for r in got[:n])


def test_broadcast_keeps_the_ep_split_tables(vocab_runs):
    """On 4 'ep' ranks: ``replicated_leaves`` of the placement flags the
    expert stacks and both tables as tiles; ``broadcast_params`` hands every
    rank rank 0's whole leaves and leaves each rank its own tiles."""
    params = vocab_runs["params"]
    place = param_placements(params, {"ep": 4})
    keep = dict(zip((p for p, _ in leaves_with_path(params)), replicated_leaves(place)))
    assert {p for p, k in keep.items() if not k} == {
        "embed/table", "head/table", "layers/moe/down", "layers/moe/gate", "layers/moe/up"}
    for r, res in enumerate(vocab_runs["ranks"]):
        mine = ep_shard(params, r, 4)
        for (path, g), m in zip(leaves_with_path(res["broadcast"]), leaves(mine)):
            assert torch.equal(g, m if keep[path] else m + r), (r, path)


def _table_figures(tc, sizes):
    """Per rank, with the split and with the tables whole: the table
    elements and the fp32 state bytes in 'none', 'so' and 'epso' (fsdp)."""
    meta = init_params(tc, device="meta")
    split = placements(tc, meta, sizes, fsdp=True)
    whole = dict(split, **{t: {"table": ((), ())} for t in ("embed", "head") if t in split})
    out = {}
    for name, place in (("split", split), ("whole", whole)):
        elems = 0
        for (path, leaf), pl in zip(leaves_with_path(meta), leaves(place)):
            if is_table_path(path):
                parts = 1
                for a in pl[0]:
                    parts *= sizes[a]
                elems += leaf.numel() // parts
        out[name] = {"table_elems": elems, **{
            mode: tepso.state_bytes_per_device(meta, place, sizes, mode)
            for mode in ("none", "so", "epso")}}
    return out


@pytest.mark.parametrize("arch,sizes", FULL_PLANS, ids=[a for a, _ in FULL_PLANS])
def test_full_size_table_split_on_meta(arch, sizes):
    """Full size with fsdp: the tables split over 'tp', else 'ep', never
    'data' or 'pp'; a rank's table elements fall by that axis; its state
    bytes fall by the tables' share in 'none' and 'so' and stay in 'epso'
    (whose states already split the tables over the model axes)."""
    tc = tget(arch)
    got = _table_figures(tc, sizes)
    print(arch, sizes, got)
    vp = padded_vocab(tc)
    tables = vp * tc.d_model * (1 if tc.tie_embeddings else 2)
    mdl = sizes.get("tp", sizes.get("ep", 1))
    assert got["whole"]["table_elems"] == tables
    assert got["split"]["table_elems"] == tables // mdl
    for mode in ("none", "so"):
        share = sizes["data"] if mode == "so" else 1
        assert got["whole"][mode] - got["split"][mode] == \
            12 * (tables // share - tables // (share * mdl)), mode
    assert got["whole"]["epso"] == got["split"]["epso"]
