"""The ``moe_down_combine`` wrapper's host side on the CPU: the work list
the kernel builds on the card (``kernels.moe.plan`` reckons it on the
host) covers every routed (row, expert) pair's columns exactly once,
heaviest expert first, in items a block holds; the constants agree with
``csrc/moe.cu``; the shape rules raise.

    PYTHONPATH=src python -m pytest -q tests/test_torch_moe_kernel.py
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import moe, ref  # noqa: E402
from test_torch_cuda import MOE_SKEWS, combine_case  # noqa: E402

CSRC = Path(moe.__file__).resolve().parent / "csrc" / "moe.cu"
CASES = ([(M, None) for M in (1, 7, 16, 128, 200, 256)]
         + [(M, s) for s, M in MOE_SKEWS])


def _pick(c: torch.Tensor) -> np.ndarray:
    """The routed pairs, as the kernel reads them: a weight whose bf16 bits
    are not +-0."""
    bits = c.contiguous().view(torch.int16).numpy().astype(np.int32)
    return (bits & 0x7FFF) != 0


@pytest.mark.parametrize("D", [2048, 200, 32])
@pytest.mark.parametrize("M,skew", CASES)
def test_plan_covers_every_routed_pair_once(M, skew, D):
    """Each routed (row, expert) pair's D columns lie in exactly one down
    item, and no other (row, expert, column) in any."""
    c = combine_case(M, M, 64, 60, 4, skew=skew)
    pick = _pick(c)
    p = moe.plan(c, D)
    cover = np.zeros((M, 64, D), np.int32)
    for it in p["items"]:
        cover[it["rows"], it["e"], it["c0"]:it["c0"] + it["width"]] += 1
    assert (cover == pick[:, :, None]).all()
    assert p["rows"] == pick.sum(0).tolist()
    assert p["combine_items"] == -(-D // 128) * -(-M // 8)


@pytest.mark.parametrize("M,skew", CASES)
def test_plan_hands_out_the_heaviest_expert_first(M, skew):
    """The experts come in order of their items' cost (rows a thread, then
    width), costliest first, ties to the lower expert; an expert's items
    are contiguous, its rows ascending in chunks of 128 and each chunk's
    column tiles in order."""
    c = combine_case(M + 1, M, 64, 60, 4, skew=skew)
    p = moe.plan(c, 2048)
    cnt = p["rows"]
    cost = [moe.item_cost(n) for n in cnt]
    assert p["order"] == sorted(range(64), key=lambda e: (-cost[e], e))
    first = {}
    for it in p["items"]:
        first.setdefault(it["e"], it)
    keys = [(-(-len(first[e]["rows"]) * first[e]["width"] // 256),
             first[e]["width"]) for e in p["order"] if cnt[e]]
    assert keys == sorted(keys, reverse=True)
    seen = [it["e"] for it in p["items"]]
    runs = [e for i, e in enumerate(seen) if i == 0 or seen[i - 1] != e]
    assert runs == [e for e in p["order"] if cnt[e]]
    want = np.flatnonzero(_pick(c)).tolist()
    for e in runs:
        mine = [it for it in p["items"] if it["e"] == e]
        rows = [r for it in mine if it["c0"] == 0 for r in it["rows"]]
        assert rows == [m for m in range(M) if m * 64 + e in set(want)]
        assert all(a["rows"] != b["rows"] or a["c0"] < b["c0"]
                   for a, b in zip(mine, mine[1:]))


@pytest.mark.parametrize("n", range(1, 129))
def test_items_fit_a_block(n):
    """An item of n rows: 128 columns up to 32 rows, 64 up to 64, else 32;
    its rows in 256 / width groups of R rows a thread, R the least bucket
    that holds them and at most 16, so no item holds more than 32 x 128
    (row, column) pairs."""
    width = moe.item_width(n)
    R = moe.thread_rows(n, width)
    groups = 256 // width
    assert width == (128 if n <= 32 else 64 if n <= 64 else 32)
    assert R in moe.R_BUCKETS and R <= 16
    assert groups * R >= n and (R == 1 or groups * moe.R_BUCKETS[
        moe.R_BUCKETS.index(R) - 1] < n)
    assert n * width <= 32 * 128


@pytest.mark.parametrize("n,cost", [(0, 0), (1, 1 * 1024 + 128),
                                    (9, 5 * 1024 + 128), (32, 16 * 1024 + 128),
                                    (33, 9 * 1024 + 64), (108, 14 * 1024 + 32),
                                    (128, 16 * 1024 + 32),
                                    (300, 16 * 1024 + 32)])
def test_item_cost_ranks_rows_a_thread_then_width(n, cost):
    """An expert's rank key: its first chunk's rows a thread x 1024, plus
    its width (the kernel's ``item_cost``, whose formula the source
    holds)."""
    assert moe.item_cost(n) == cost
    assert ("return n == 0 ? 0 : ((n < kMaxRows ? n : kMaxRows) * "
            "item_width(n) + 255) / 256 * 1024 + item_width(n);"
            in " ".join(CSRC.read_text().split()))


def _const(name: str) -> str:
    m = re.search(rf"constexpr int {name}(?:\[\])? = (\{{[^}}]*\}}|\d+);",
                  CSRC.read_text())
    assert m, name
    return m.group(1)


def test_constants_agree_with_the_cuda_source():
    """The host reckoning's constants are the kernel's, and so is the
    width rule."""
    assert int(_const("kTD")) == moe.TD
    assert int(_const("kFC")) == moe.FC
    assert int(_const("kStages")) == moe.STAGES
    assert int(_const("kMaxRows")) == moe.MAX_ROWS
    assert int(_const("kMaxE")) == moe.MAX_E
    assert int(_const("kCombineRows")) == moe.COMBINE_ROWS
    assert int(_const("kConsumers")) == moe.CONSUMERS
    buckets = tuple(int(x) for x in re.findall(r"\d+",
                                                _const("kRBuckets")))
    assert buckets == moe.R_BUCKETS
    assert "return n <= 32 ? 128 : n <= 64 ? 64 : 32;" in CSRC.read_text()


def _bf(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("shapes,dtype,err,match", [
    (((4, 4, 48), (4, 48, 16), (4, 4)), torch.bfloat16, ValueError,
     "F a multiple of 32"),
    (((4, 8, 32), (8, 32, 12), (4, 8)), torch.bfloat16, ValueError,
     "D of 8"),
    (((4, 12, 32), (12, 32, 16), (4, 12)), torch.bfloat16, ValueError,
     "E a multiple of 8"),
    (((4, 264, 32), (264, 32, 16), (4, 264)), torch.bfloat16, ValueError,
     "up to 256"),
    (((4, 8, 32), (8, 32, 16), (4, 8)), torch.float32, TypeError, "bf16"),
    (((4, 8, 32), (8, 32, 16), (4, 9)), torch.bfloat16, ValueError,
     "shapes"),
])
def test_check_refuses_what_the_kernel_does_not_take(shapes, dtype, err,
                                                     match):
    h, w, c = (_bf(s, dtype) for s in shapes)
    with pytest.raises(err, match=match):
        moe._check(h, w, c)


def test_check_takes_the_moe_configs_shapes():
    """qwen2-moe-a2.7b's and moonshot's (64 experts, F 1408, D 2048) and the
    smoke configs' (16 experts, F 32, D 32) pass."""
    for E, F, D in ((64, 1408, 2048), (16, 32, 32)):
        moe._check(_bf((3, E, F)), _bf((E, F, D)), _bf((3, E)))


def test_wrapper_on_the_cpu_is_the_plain_version():
    """A CPU tensor takes the plain version and no launch."""
    rng = np.random.default_rng(0)
    h = torch.as_tensor(rng.standard_normal((5, 8, 32)),
                        dtype=torch.float32).to(torch.bfloat16)
    w = torch.as_tensor(rng.standard_normal((8, 32, 16)) / 6,
                        dtype=torch.float32).to(torch.bfloat16)
    c = combine_case(1, 5, 8, 8, 2)
    before = moe.launches
    assert torch.equal(moe.moe_down_combine(h, w, c),
                       ref.moe_down_combine_ref(h, w, c))
    assert moe.launches == before


@pytest.mark.parametrize("E", [16, 8])
def test_float32_output_rounds_to_the_bf16_bits(E):
    """``out_dtype=float32`` (a rank's partial over its experts under
    tensor parallelism): the plain version's float32 sum, which rounds to
    the bf16 version's bits; the wrapper on the CPU is that plain version;
    another dtype, or the float32 output with a gradient, raises."""
    rng = np.random.default_rng(E)
    h = torch.as_tensor(rng.standard_normal((7, E, 32)),
                        dtype=torch.float32).to(torch.bfloat16)
    w = torch.as_tensor(rng.standard_normal((E, 32, 24)) / 6,
                        dtype=torch.float32).to(torch.bfloat16)
    c = combine_case(2, 7, E, E, 2)
    f32 = ref.moe_down_combine_ref(h, w, c, torch.float32)
    assert f32.dtype == torch.float32
    assert torch.equal(f32.to(torch.bfloat16), ref.moe_down_combine_ref(h, w, c))
    assert torch.equal(moe.moe_down_combine(h, w, c, torch.float32), f32)
    with pytest.raises(TypeError, match="bf16 or float32"):
        moe.moe_down_combine(h, w, c, torch.float16)
    with pytest.raises(ValueError, match="serving output"):
        moe.moe_down_combine(h.requires_grad_(), w, c, torch.float32)


def test_float32_output_reaches_the_cuda_source():
    """The launch passes ``out_f32`` (the ctypes signature holds one more
    int than the four shapes) and the combine writes float32 with it."""
    from repro_torch.kernels import _build

    sig = _build.SIGNATURES["moe"]["moe_down_combine"]
    assert sig.count(_build._I) == 5
    src = CSRC.read_text()
    assert "int out_f32, void* stream" in src and "if (p.out_f32)" in src
