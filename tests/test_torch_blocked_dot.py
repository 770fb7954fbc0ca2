"""The port's blocked dot and int8 probe against the JAX tool.

``tools/microbench_int8.py`` is loaded by path, unedited. Its
``pallas_dot`` runs in Pallas interpret mode (``pl.pallas_call``
patched with ``interpret=True``) and its chains at CHAIN=3; the port's
``pallas_dot`` and ``chain_dot`` take the same numpy inputs on the CPU,
where ``blocked_dot`` runs its plain version.

Tolerances: int8 is exact on both sides (int32 sums that cannot
overflow, the same shift and wrap), so it is held bit for bit. A single
bf16 dot is held to rtol 1e-5, atol 1e-4: f32 sums in another order
against one rounding from float64. Over a bf16 chain that order can flip
one bf16 rounding of an intermediate by an ulp (2^-8 relative), and the
next dots carry the flip; the chain sums are held to rtol 1e-4, and the
cases below differ by at most 1.1e-7 relative on their seeds (one f32
ulp of the sum), the single dots by at most 3.9e-6 on outputs up to 35.
"""

import functools
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hsi_dmgasr_tpu_torch.kernels import blocked_dot as bd
from hsi_dmgasr_tpu_torch.tools import microbench_int8 as port_tool

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (K, N): square, K > N (the link is zero-padded back to K), K < N (sliced)
SHAPES = [(64, 64), (96, 64), (32, 64)]
M, BLOCK = 64, 32


@pytest.fixture()
def jax_tool(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_microbench_int8", ROOT / "tools" / "microbench_int8.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "CHAIN", 3)
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(port_tool, "CHAIN", 3)
    return mod


def _operands(k, n, dt, seed=0):
    """(x, w) as numpy: int8 in [-127, 127], or f32 normals that both
    frameworks round to the same bf16."""
    rng = np.random.RandomState(seed)
    if dt == "int8":
        return (rng.randint(-127, 128, (M, k)).astype(np.int8),
                rng.randint(-127, 128, (k, n)).astype(np.int8))
    return rng.randn(M, k).astype(np.float32), rng.randn(k, n).astype(np.float32)


def _to_jax(a, dt):
    return jnp.asarray(a, jnp.int8 if dt == "int8" else jnp.bfloat16)


def _to_torch(a, dt):
    return torch.tensor(a).to(torch.int8 if dt == "int8" else torch.bfloat16)


@pytest.mark.parametrize("dt", ["int8", "bf16"])
@pytest.mark.parametrize("k,n", SHAPES)
def test_plain_matches_dot_general(k, n, dt):
    x, w = _operands(k, n, dt, seed=1)
    pref = jnp.int32 if dt == "int8" else jnp.float32
    want = np.asarray(jax.lax.dot_general(_to_jax(x, dt), _to_jax(w, dt), (((1,), (0,)), ((), ())),
                                          preferred_element_type=pref))
    got = bd.blocked_dot_plain(_to_torch(x, dt), _to_torch(w, dt))
    assert got.dtype == (torch.int32 if dt == "int8" else torch.float32)
    if dt == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dt", ["int8", "bf16"])
@pytest.mark.parametrize("k,n", SHAPES)
def test_chains_match_jax_tool(jax_tool, k, n, dt):
    """The port's pallas_dot and chain_dot against the JAX tool's, with
    32 x 32 blocks, over three links."""
    x, w = _operands(k, n, dt)
    jpref = jnp.int32 if dt == "int8" else jnp.float32
    tpref = torch.int32 if dt == "int8" else torch.float32
    want = float(jax_tool.pallas_dot(_to_jax(w, dt), jpref, BLOCK, BLOCK, _to_jax(x, dt)))
    assert want == float(jax_tool.chain_dot(_to_jax(w, dt), jpref, _to_jax(x, dt)))
    n0 = bd.LAUNCHES
    got = port_tool.pallas_dot(_to_torch(w, dt), tpref, BLOCK, BLOCK, _to_torch(x, dt))
    lib = port_tool.chain_dot(_to_torch(w, dt), tpref, _to_torch(x, dt))
    assert bd.LAUNCHES == n0
    if dt == "int8":
        assert float(got) == want and float(lib) == want
    else:
        np.testing.assert_allclose([float(got), float(lib)], want, rtol=1e-4)


@pytest.mark.parametrize("k,n", SHAPES)
def test_int8_chain_matches_numpy(k, n):
    """Every element of the last link, not only the sum: a numpy chain in
    int64 with an arithmetic shift and a two's-complement wrap."""
    x, w = _operands(k, n, "int8", seed=2)
    a = x
    for _ in range(3):
        y = (a.astype(np.int64) @ w.astype(np.int64)) >> 7
        a2 = y.astype(np.int8)
        a = a2[:, :k] if n >= k else np.pad(a2, ((0, 0), (0, k - n)))
    got = port_tool.run_chain(port_tool.kernel_dot(_to_torch(w, "int8"), BLOCK, BLOCK),
                              _to_torch(x, "int8"), 3)
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), a)


def test_requantize_wraps_as_jax_astype():
    y = torch.tensor([[9000000, -9000000, 70000]], dtype=torch.int32)
    a = torch.zeros((1, 3), dtype=torch.int8)
    got = port_tool.requantize(y, a)
    want = np.asarray((jnp.asarray(y.numpy()) >> 7).astype(jnp.int8))
    assert got.tolist() == [[-88, 87, 34]] == want.tolist()


def test_pack_dot_weight_is_k_major():
    w = torch.arange(12, dtype=torch.int8).reshape(3, 4)
    wp = bd.pack_dot_weight(w)
    assert wp.shape == (4, 3) and wp.is_contiguous() and torch.equal(wp, w.t())


def test_cpu_tensors_take_the_plain_version():
    x, w = _operands(64, 64, "int8", seed=3)
    xt, wt = _to_torch(x, "int8"), _to_torch(w, "int8")
    n0 = bd.LAUNCHES
    got = bd.blocked_dot(xt, bd.pack_dot_weight(wt), 32, 64)
    assert bd.LAUNCHES == n0
    assert torch.equal(got, bd.blocked_dot_plain(xt, wt))


@pytest.mark.parametrize("shape,kw,match", [
    ((64, 64, 64), {"bm": 24}, "not tiled"),          # ragged M
    ((64, 64, 48), {"bn": 32}, "not tiled"),          # ragged N
    ((64, 48, 64), {}, "multiple of 32"),             # int8 K off the MMA's k
    ((64, 24, 64), {"dtype": torch.bfloat16}, "multiple of 16"),
    ((64, 64, 64), {"dtype": torch.float32}, "dtypes"),
    ((64, 64, 64), {"w_dtype": torch.bfloat16}, "dtypes"),
    ((64, 64, 64), {"w_k": 32}, "packed w"),
    ((64, 64, 64), {"transpose": True}, "contiguous"),
])
def test_what_the_kernel_does_not_take_raises(shape, kw, match):
    m, k, n = shape
    dtype = kw.get("dtype", torch.int8)
    x = torch.zeros((m, k), dtype=dtype)
    if kw.get("transpose"):
        x = torch.zeros((k, m), dtype=dtype).t()
    wp = torch.zeros((n, kw.get("w_k", k)), dtype=kw.get("w_dtype", dtype))
    with pytest.raises(ValueError, match=match):
        bd.blocked_dot(x, wp, kw.get("bm", 32), kw.get("bn", 16))


def test_other_devices_raise():
    x = torch.empty((64, 64), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bd.blocked_dot(x, x, 32, 32)


def test_preferred_must_match_the_operands():
    w = torch.zeros((32, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="preferred"):
        port_tool.pallas_dot(w, torch.float32, 32, 32, torch.zeros((32, 32), dtype=torch.int8))


def test_bound_is_the_byte_bound_at_the_probe_shapes():
    """Every case is bound by its 4-byte output: the numbers of the
    reckoning in PERF.md (H100 SXM peaks)."""
    want = {("square_4096x512x512", "int8"): 3.21, ("square_4096x512x512", "bf16"): 3.91,
            ("rbup_block1_dxpack", "int8"): 2.00, ("rbup_block1_dxpack", "bf16"): 2.75,
            ("rb512_dxpack", "int8"): 1.50, ("rb512_dxpack", "bf16"): 1.75}
    for name, m, k, n, _, _ in port_tool.CASES:
        for dt in ("int8", "bf16"):
            s, by = port_tool.dot_bound(m, k, n, dt)
            assert by == "bytes" and round(s * 1e6, 2) == want[name, dt]


def test_main_on_the_cpu_prints_the_jax_keys(monkeypatch, capsys):
    monkeypatch.setattr(port_tool, "CHAIN", 2)
    monkeypatch.setattr(port_tool, "CASES", [("tiny", 64, 96, 64, 32, 32)])
    port_tool.main(["--cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu"
    rows = [json.loads(line) for line in lines[1:]]
    assert [(r["path"], r["dtype"]) for r in rows] == [
        ("library", "bf16"), ("cuda", "bf16"), ("library", "int8"), ("cuda", "int8")]
    for r in rows:
        assert set(r) == {"case", "path", "dtype", "us_per_dot", "achieved_TOPs", "bound_us"}
        assert r["case"] == "tiny" and r["us_per_dot"] > 0


def test_probe_rows_on_the_cpu(monkeypatch):
    """Both paths of an int8 chain sum exactly, so their last links agree
    bit for bit; the CPU makes no kernel launch."""
    monkeypatch.setattr(port_tool, "CHAIN", 3)
    monkeypatch.setattr(port_tool, "CASES", [("pad", 64, 96, 64, 32, 32),
                                             ("slice", 64, 32, 64, 32, 32)])
    rows = port_tool.probe(torch.device("cpu"))
    assert len(rows) == 8
    for r in rows:
        assert r["launches"] == 0 and r["seconds"] > 0
        assert r["us_per_dot"] == pytest.approx(r["seconds"] / 3 * 1e6)
    for case in ("pad", "slice"):
        int8 = [r["checksum"] for r in rows if r["case"] == case and r["dtype"] == "int8"]
        assert len(int8) == 2 and int8[0] == int8[1]


def test_main_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU behaviour")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_tool.main([])
