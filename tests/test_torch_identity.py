"""A query row's bits do not depend on the step shape that carried it, on
the CPU (the plain versions; ``chip_smoke.py``'s batch-shape probe holds
the kernels on the card).

- The plain ragged attention (row 3) of a row equals the plain decode
  attention (row 4) of that row alone at its own length, bitwise, at 1
  and at 5 query rows per item (a k 4 verify item), f32 and bf16, at the
  served lengths and at long prefixes over many pages.
- ``launch.executor.route_rows`` hands a unified step's logit rows
  (decode rows, verify rows, a completing chunk's last row) to the decode
  attention at their own lengths and masks them out of the ragged blocks;
  ``ops.step_paged_attention`` then gives every row the bits of the
  ragged attention over the scheduler's blocks, launching the decode
  attention on exactly the logit rows.
- The decode prologue's plain version rounds bf16 rows where the card's
  composed path does (the fused linear's bf16 output, RoPE, the KV
  quant), so its q, codes and scales equal that path's bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.hadamard import hadamard_factors
from repro_torch.core.quantizers import pack_int4
from repro_torch.kernels import decode_layer as L
from repro_torch.kernels import fused_cat_matmul as F
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as P
from repro_torch.launch.executor import route_rows
from repro_torch.launch.paged import PagePool, SlotPageTables
from repro_torch.launch.scheduler import Request, TokenBudgetScheduler
from repro_torch.models.layers import quantize_kv, rope

torch.set_num_threads(1)

KVH, G, HD, PS = 4, 2, 64, 16


def _pool(gen, n_pages):
    kp = torch.randint(-127, 128, (n_pages, PS, KVH, HD), generator=gen,
                       dtype=torch.int8)
    vp = torch.randint(-127, 128, (n_pages, PS, KVH, HD), generator=gen,
                       dtype=torch.int8)
    ks = torch.rand((n_pages, PS, KVH, 1), generator=gen) * 0.02 + 0.001
    vs = torch.rand((n_pages, PS, KVH, 1), generator=gen) * 0.02 + 0.001
    return kp, ks, vp, vs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("nq", [1, 5])
def test_plain_ragged_rows_equal_plain_decode(nq, dtype):
    gen = torch.Generator().manual_seed(nq)
    lengths = [9, 17, 24, 40, 56, 129, 160, 700, 2048]
    n_ptab = -(-max(lengths) // PS)
    pools = _pool(gen, 1 + len(lengths) * n_ptab)
    table = torch.zeros((len(lengths), n_ptab), dtype=torch.int32)
    for i, ln in enumerate(lengths):
        used = -(-ln // PS)
        table[i, :used] = 1 + i * n_ptab + torch.arange(used)
    last = torch.tensor(lengths, dtype=torch.int32)
    qpos = (last[:, None] - nq + torch.arange(nq, dtype=torch.int32)
            ).to(torch.int32)
    q = torch.randn((len(lengths), nq, KVH, G, HD), generator=gen).to(dtype)
    ragged = P.paged_attention_ragged_plain(q, *pools, table, last, qpos)
    rows = len(lengths) * nq
    decode = P.paged_attention_decode_plain(
        q.reshape(rows, KVH, G, HD), *pools, table.repeat_interleave(nq, 0),
        (qpos.reshape(-1) + 1).to(torch.int32))
    assert torch.equal(ragged.reshape(rows, KVH, G, HD), decode)


def _packed_steps():
    """Three unified steps of a two-slot scheduler (budget 16, chunks of
    8): a 5-token prompt and a 20-token one, prefilled beside each other's
    decode rows -> [(plan, packed arrays with the ragged descriptor)]."""
    pool = PagePool(1 + 2 * 4, PS)
    tables = SlotPageTables(pool, 2, 4)
    sched = TokenBudgetScheduler(2, 16, pool=pool, tables=tables,
                                 prefill_chunk=8)
    sched.queue.append(Request(0, np.arange(1, 6, dtype=np.int32), 8))
    sched.queue.append(Request(1, np.arange(1, 21, dtype=np.int32), 4))
    plans = []
    for step in range(3):
        plan = sched.plan(step)
        packed = sched.pack(plan, kernel_desc=True)
        plans.append((plan, packed))
        toks = np.full((packed["n_logits"],), 7, np.int32)
        sched.observe(plan, toks, now=0.0)
    return plans


def test_route_rows_sends_logit_rows_to_the_decode_attention(monkeypatch):
    gen = torch.Generator().manual_seed(0)
    pools = _pool(gen, 1 + 2 * 4)
    seen = []
    real = ops.paged_attention

    def spy(q, *a):
        seen.append(q.shape[0])
        return real(q, *a)
    monkeypatch.setattr(ops, "paged_attention", spy)
    for _, packed in _packed_steps():
        desc = packed["ragged_desc"]
        routed = route_rows(packed, desc)
        n = packed["n_logits"]
        rows = packed["logit_rows"][:n]
        assert routed["n_dec"] == n
        assert (routed["dec_rows"][:n] == rows).all()
        assert (routed["dec_len"][:n] == packed["pos"][rows] + 1).all()
        assert (routed["dec_table"][:n] == packed["page_table"][rows]).all()
        masked = routed["qpos"][desc["inv_seq"][rows], desc["inv_qi"][rows]]
        assert (masked == -1).all()
        assert routed["n_ragged"] == int((desc["qpos"] >= 0).sum()) - n
        t = packed["tokens"].shape[0]
        q = torch.randn((t, KVH, G, HD), generator=gen).to(torch.bfloat16)
        dev = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in routed.items()}
        seen.clear()
        got = ops.step_paged_attention(q, *pools, dev)
        assert seen == [n]
        d = {k: torch.as_tensor(v) for k, v in desc.items()}
        want = P.paged_attention_ragged_plain(
            q[d["qidx"].long()], *pools, d["table"], d["lengths"],
            d["qpos"])[d["inv_seq"].long(), d["inv_qi"].long()]
        real_rows = torch.as_tensor(
            np.flatnonzero(desc["qpos"].reshape(-1) >= 0))
        flat = desc["qidx"].reshape(-1)[real_rows.numpy()]
        assert torch.equal(got[flat], want[flat])


def test_prologue_bf16_rows_equal_the_composed_path():
    gen = torch.Generator().manual_seed(5)
    m, d, n_q, kvh, hd = 4, 256, 256, 2, 64
    n = n_q + 2 * kvh * hd
    x = torch.randn((m, d), generator=gen).to(torch.bfloat16)
    blocks = (torch.randn((d // 32, 32, 32), generator=gen) * 0.2
              + torch.eye(32))
    ha, hb = (torch.tensor(h, dtype=torch.float32)
              for h in hadamard_factors(d))
    sign = torch.randint(0, 2, (d,), generator=gen).float() * 2 - 1
    qw = pack_int4(torch.randint(-8, 8, (d, n), generator=gen,
                                 dtype=torch.int8), axis=0)
    sw = torch.rand((1, n), generator=gen) * 0.02 + 0.001
    pool = [torch.zeros((6, PS, kvh, hd), dtype=torch.int8),
            torch.zeros((6, PS, kvh, 1)),
            torch.zeros((6, PS, kvh, hd), dtype=torch.int8),
            torch.zeros((6, PS, kvh, 1))]
    pids = torch.tensor([1, 2, 3, 5], dtype=torch.int32)
    rows = torch.tensor([0, 7, 15, 3], dtype=torch.int32)
    pos = torch.tensor([0, 23, 47, 83], dtype=torch.int32)
    q, kp, ks, vp, vs = L.decode_qkv_prologue_plain(
        x, blocks, ha, hb, sign, qw, sw, *pool, pids, rows, pos, n_q=n_q,
        head_dim=hd, rope_theta=10000.0, kv_bits=8, act_bits=4)
    # the card's composed path: the fused linear's output in x's dtype,
    # RoPE on it, then the KV quant of the rope'd bf16 k and of v
    y = F.fused_cat_linear_plain(x, blocks, ha, hb, sign, qw, sw,
                                 act_bits=4).to(torch.bfloat16)
    p2 = pos[:, None]
    q_want = rope(y[:, :n_q].reshape(m, 1, -1, hd), p2, 10000.0)
    k = rope(y[:, n_q:n_q + kvh * hd].reshape(m, 1, kvh, hd), p2, 10000.0)
    v = y[:, n_q + kvh * hd:].reshape(m, 1, kvh, hd)
    kq, kscale = quantize_kv(k, 8)
    vq, vscale = quantize_kv(v, 8)
    assert q.dtype == torch.float32
    assert torch.equal(q, q_want.reshape(m, n_q).float())
    sel = (pids.long(), rows.long())
    assert torch.equal(kp[sel], kq[:, 0]) and torch.equal(vp[sel], vq[:, 0])
    assert torch.equal(ks[sel], kscale[:, 0])
    assert torch.equal(vs[sel], vscale[:, 0])
