"""The port's transformer LM against the JAX package's, on the CPU.

Same seeded weights and inputs through ``mxnet_tpu``'s
``paged_step_apply`` (plain XLA lowering, ``MXNET_PALLAS=0``) and the
port's (plain PyTorch versions on CPU tensors); logits and the updated
pools must agree within fp32 tolerance.  Also: the parameter draws are
bit-identical, the weight carrier round-trips, the port refuses to run
silently on the CPU, and neither the port nor ``chip_smoke.py`` imports
JAX or the JAX package.
"""
import ast
import importlib
import os

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import context
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer_lm as tlm

jlm = importlib.import_module("mxnet_tpu.models.transformer_lm")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = tlm.lm_spec(num_layers=2, num_hidden=32, num_heads=4, vocab_size=50)
BS, NB, T = 8, 16, 5


@pytest.mark.parametrize("spec,seed", [
    (SPEC, 3), (tlm.lm_spec(1, 16, 2, 20), 0),
    (tlm.lm_spec(3, 24, 3, 37), 11)])
def test_random_params_bit_identical_to_jax(spec, seed):
    want = jlm.random_params(spec, seed=seed)
    got = tlm.random_params(spec, seed=seed)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == np.float32
        assert np.array_equal(got[name], want[name]), name


def test_from_numpy_round_trips_and_validates():
    params = tlm.random_params(SPEC, seed=1)
    model = tlm.TransformerLM.from_numpy(params, SPEC, device="cpu")
    back = model.to_numpy()
    assert sorted(back) == sorted(params)
    for name in params:
        assert np.array_equal(back[name], params[name])
    assert model.device.type == "cpu"
    missing = dict(params)
    missing.pop("blk1_q_weight")
    with pytest.raises(MXNetError, match="blk1_q_weight"):
        tlm.TransformerLM.from_numpy(missing, SPEC, device="cpu")
    bad = dict(params, pred_bias=np.zeros(3, np.float32))
    with pytest.raises(MXNetError, match="pred_bias"):
        tlm.TransformerLM.from_numpy(bad, SPEC, device="cpu")


def test_default_device_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="device='cpu'"):
        context.default_device()
    with pytest.raises(MXNetError):
        tlm.TransformerLM.from_numpy(tlm.random_params(SPEC), SPEC)
    assert context.default_device("cpu") == torch.device("cpu")
    with pytest.raises(MXNetError):
        context.default_device("meta")


def _step_inputs():
    """A prefill chunk with ragged valid rows, a shared physical block
    and a table running into the trash block, then a decode step."""
    rs = np.random.RandomState(0)
    tables = np.zeros((3, T), np.int32)
    tables[0, :2] = [1, 2]
    tables[1, :3] = [3, 4, 5]
    tables[2, :2] = [3, 6]            # shares sequence 1's first block
    chunk = dict(tokens=rs.randint(0, 50, (3, 8)).astype(np.int32),
                 positions=np.array([0, 8, 8], np.int32),
                 valid=np.array([8, 5, 3], np.int32))
    decode = dict(tokens=rs.randint(0, 50, (3, 1)).astype(np.int32),
                  positions=np.array([8, 13, 11], np.int32),
                  valid=np.ones(3, np.int32))
    return tables, chunk, decode


@pytest.mark.parametrize("all_logits", [False, True])
def test_paged_step_matches_jax(monkeypatch, all_logits):
    monkeypatch.setenv("MXNET_PALLAS", "0")
    params = tlm.random_params(SPEC, seed=3)
    model = tlm.TransformerLM.from_numpy(params, SPEC, device="cpu")
    tables, chunk, decode = _step_inputs()
    jk, jv = jlm.init_pool(SPEC, NB, BS)
    tk, tv = tlm.init_pool(SPEC, NB, BS)
    for step in (chunk, decode):
        jl, jk, jv = jlm.paged_step_apply(params, jk, jv, tables,
                                          step["tokens"], step["positions"],
                                          step["valid"], SPEC, BS,
                                          all_logits=all_logits)
        tl, tk2, tv2 = model(tk, tv, tables, step["tokens"],
                             step["positions"], step["valid"], BS,
                             all_logits=all_logits)
        assert tk2 is tk and tv2 is tv   # the pools update in place
        assert tl.shape == tuple(np.shape(jl)) and tl.dtype == torch.float32
        assert np.abs(tl.numpy() - np.asarray(jl)).max() <= 1e-4
        assert np.abs(tk.numpy() - np.asarray(jk)).max() <= 1e-4
        assert np.abs(tv.numpy() - np.asarray(jv)).max() <= 1e-4


def test_paged_step_pad_rows_write_only_the_trash_block():
    """Pad rows (r >= valid) scatter into block 0; rows of real blocks
    past each sequence's valid tokens stay untouched."""
    params = tlm.random_params(SPEC, seed=4)
    model = tlm.TransformerLM.from_numpy(params, SPEC, device="cpu")
    tables, chunk, _ = _step_inputs()
    pk, pv = tlm.init_pool(SPEC, NB, BS)
    model(pk, pv, tables, chunk["tokens"], chunk["positions"],
          chunk["valid"], BS)
    written = set()
    for b in range(3):
        for r in range(int(chunk["valid"][b])):
            p = int(chunk["positions"][b]) + r
            written.add(int(tables[b, p // BS]) * BS + p % BS)
    nonzero = set(np.nonzero(np.abs(pk.numpy()).sum(axis=(0, 1, 3)))[0])
    assert nonzero - written <= set(range(BS))   # extra rows: trash only
    assert written <= nonzero


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "mxnet_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 10
    for path in paths:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "mxnet_tpu"), (path, mod)
