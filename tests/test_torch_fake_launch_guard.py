"""Every ctypes kernel wrapper of the port refuses a fake CUDA tensor
(``FakeTensorMode``: the dry run's tensors, which have no device memory)
with a clear error instead of launching on pointers to nothing: B1, B4,
B6 (``kernels/snp_step/ops.py``), the sliced-list kernel of B2, B3, B5
and B7 (``sparse_ops.py``), H1's three bodies and H2 into a given or a
fresh table (``kernels/hashtable/ops.py``),
the level loop's graph (``core/graph_loop.py``) and B8
(``flash_attention_cuda``).  B8's custom operator, run on fake tensors,
gives its output's shape without a launch."""

import types

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.core.graph_loop import FusedLoop  # noqa: E402
from repro_torch.kernels import real  # noqa: E402
from repro_torch.kernels.flash_attn import ops as attn  # noqa: E402
from repro_torch.kernels.hashtable import ops as table  # noqa: E402
from repro_torch.kernels.snp_step import ops, sparse_ops  # noqa: E402

i32, i64, b8, f32 = torch.int32, torch.int64, torch.bool, torch.float32
B, m, n, T = 2, 8, 12, 4


def t(*shape, dtype=i32):
    return torch.zeros(shape, dtype=dtype, device="cuda")


def _b1():
    ops.snp_step_dense(t(B, m), t(B, n), t(B, n, dtype=b8), t(B, m),
                       t(B, m), t(B, dtype=f32), t(n),
                       (t(m + 2), t(5), t(5)), T)


def _b4():
    ops.snp_step_dense_delay(t(B, m), t(B, m), t(B, m), t(B, n),
                             t(B, n, dtype=b8), t(B, m), t(B, m),
                             t(B, dtype=f32), t(m + 1), t(n), t(n), t(n),
                             t(2), t(64), t(1), T)


def _b6():
    ops.snp_step_dense_shard_cuda(t(B, m), t(B, n), t(B, n, dtype=b8),
                                  t(B, m), t(B, m), t(B, dtype=f32), t(n),
                                  (t(m + 1), t(5), t(5), t(m + 1), t(3)),
                                  t(B, T, 3), T)


def _sparse():
    sparse_ops.snp_step_sparse_cuda(t(B, m), t(B, m, dtype=f32), t(B, m),
                                    t(B, dtype=f32), t(B, m, 4), t(2),
                                    t(64), t(1), max_branches=T)


def _h1():
    table.lookup(t(16, dtype=i64), t(16, dtype=i64), t(16), t(4, dtype=i64),
                 t(4, dtype=i64), t(4, dtype=b8), 8)


def _h2():
    table.claim_(t(16, dtype=i64), t(16, dtype=i64), t(16),
                 t(4, dtype=i64), t(4, dtype=i64), t(4, dtype=b8), t(4), 8)


def _h1_rows():
    table.hash_lookup(t(16, dtype=i64), t(16, dtype=i64), t(16), t(4, 7),
                      t(4, dtype=b8), 8)


def _h1_hash():
    table.config_hash(t(4, 7))


def _h2_first():
    table.first_claim(t(4, dtype=i64), t(4, dtype=i64), t(4, dtype=b8), 16,
                      8)


def _graph_loop():
    state = types.SimpleNamespace(step=t(), total_new=t())
    FusedLoop(lambda s: None, state, [torch.device("cuda", 0)]).run(
        4, 0, True)


def _b8():
    q = t(1, 2, 16, 64, dtype=f32)
    attn.flash_attention_cuda(q, q, q, t(1))


WRAPPERS = {"B1": (_b1, "B1"), "B4": (_b4, "B4"), "B6": (_b6, "B6"),
            "B2-B3-B5-B7": (_sparse, "B2, B3, B5, B7"),
            "H1": (_h1, "H1"), "H2": (_h2, "H2"),
            "H1-rows": (_h1_rows, "hash_lookup (H1)"),
            "H1-hash": (_h1_hash, "config_hash (H1)"),
            "H2-first": (_h2_first, "first_claim (H2)"),
            "graph_loop": (_graph_loop, "graph_loop_launch"),
            "B8": (_b8, "flash_attention_cuda")}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_refuses_a_fake_cuda_tensor(name):
    call, label = WRAPPERS[name]
    with FakeTensorMode():
        with pytest.raises(RuntimeError, match="fake tensor") as err:
            call()
    assert label in str(err.value)


def test_meta_tensors_are_refused_too():
    with pytest.raises(RuntimeError, match="meta tensor"):
        real.require_real("kernel", None, torch.empty(3, device="meta"))
    real.require_real("kernel", torch.zeros(3), None)     # real: no error


def test_b8_custom_op_on_fake_tensors_gives_the_shape_only():
    launches = (attn.kernel_launches, attn.kernel_launches_tc,
                attn.plain_calls)
    with FakeTensorMode():
        q = t(2, 4, 16, 64, dtype=torch.bfloat16)
        k = t(2, 2, 16, 64, dtype=torch.bfloat16)
        out = attn.flash_attention(q, k, k)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.device.type == "cuda"
    assert (attn.kernel_launches, attn.kernel_launches_tc,
            attn.plain_calls) == launches
