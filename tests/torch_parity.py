"""Helpers of the port's training parity tests (``test_torch_train.py``,
``test_torch_mamba1.py``, ``test_torch_ssm_train.py``): the same numpy
batch for both packages, and leaf-by-leaf comparison of a port tree with
a JAX tree."""
import jax
import jax.numpy as jnp
import numpy as np
import torch


def batch_pair(seed, b=4, s=16, vocab=128):
    """One next-token batch as (JAX dict, port dict); row 0's last three
    labels are masked (-100)."""
    toks = np.random.default_rng(seed).integers(0, vocab, size=(b, s + 1)).astype(np.int32)
    toks[0, -3:] = -100
    tokens, labels = np.maximum(toks[:, :-1], 0), toks[:, 1:]
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()})


def jax_leaves(tree) -> dict:
    """{path: numpy array} of a JAX tree, paths as the port's 'layers/moe/gate'."""
    return {jax.tree_util.keystr(p).replace("['", "").replace("']", "/").rstrip("/"):
            np.asarray(x) for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def assert_leaves_close(tl: dict, jp, what: str, rel_atol: float = 1e-4) -> None:
    """tl: {path: tensor} of the port's leaves; jp: the JAX tree. Each leaf
    within rtol 1e-3 and atol ``rel_atol`` * its max|value| (sums of many
    terms in another order)."""
    jl = jax_leaves(jp)
    assert sorted(tl) == sorted(jl), what
    for path, leaf in tl.items():
        ref = jl[path]
        np.testing.assert_allclose(leaf.detach().numpy(), ref, rtol=1e-3,
                                   atol=rel_atol * max(np.abs(ref).max(), 1e-6),
                                   err_msg=f"{what} {path}")
