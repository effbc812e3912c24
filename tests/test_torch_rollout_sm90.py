"""The host side of K1, the fp32 decode rollout (``csrc/gru_rollout.cu``):
its plan, the W_hh bank packed into the ring's stages, the wrapper's call of
the C entry, and the reassociated gate sums of the kernel against the plain
version.  The kernel itself runs only on the card, where ``chip_smoke.py``
holds it against ``gru_rollout_plain`` at 12 800, 12 795 and 12 760 rows.
"""
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu_torch.ops.graph_linear import gmix_nm, gmm_nm, l1_normalize_rows
from skeletondiffusion_tpu_torch.ops.kernels import build
from skeletondiffusion_tpu_torch.ops.kernels import gru_rollout as rollout
from skeletondiffusion_tpu_torch.ops.kernels import node_mix_sm90 as engine

N, H, F = 21, 96, 3
SLICE, K_ROWS = rollout.ROLLOUT_SLICE, rollout.ROLLOUT_K_ROWS


def _layout_bytes(stages):
    """One block's shared memory, piece by piece as ``layout`` in
    ``csrc/gru_rollout.cu`` places it."""
    barriers = 128                                  # 6 full, 6 empty, cx_full, p_free
    ring = stages * 4 * K_ROWS * N * 3 * SLICE      # bank rows × nodes × r|z|n columns
    h = 4 * N * (8 * (H + 4) + 4)                   # h, rows and planes one bank quad on
    p = 4 * N * 4 * 8 * SLICE                       # r, z, n_h, n_x areas of a slice
    g = 4 * 3 * N * 24                              # G_t, G_add, G_fc
    return barriers + ring + h + p + g


def test_bench_plan_is_the_documented_one():
    assert tuple(rollout.rollout_plan(N, H)) == (8, 32, 2, 4, 224240)


def test_plan_fits_and_matches_the_kernels_layout():
    plan = rollout.rollout_plan(N, H)
    assert plan.smem_bytes == _layout_bytes(plan.stages) <= engine.MAX_SMEM
    # as many stages as fit; each weight byte from L2 serves the cluster's 32 rows
    assert _layout_bytes(plan.stages + 1) > engine.MAX_SMEM
    assert plan.rows * plan.cluster == 32
    # a stage holds W_fc whole, and a block's part of either is whole 16-byte chunks
    stage = 4 * K_ROWS * N * 3 * SLICE
    assert 4 * N * H * F <= stage and stage % (16 * plan.cluster) == 0
    assert (4 * N * H * F) % (16 * plan.cluster) == 0


def _chunk_at(m, c):
    """Where the packed stage keeps 16-byte chunk c of node m's row."""
    return c ^ ((m & 1) << 2)


@pytest.mark.parametrize("slice_index", range(H // SLICE))
def test_each_stage_of_the_packed_bank_is_the_bank_rows_the_kernel_reads(slice_index):
    """Stage ks of slice J is bank rows 4·ks … 4·ks + 3, each the 21 nodes'
    r, z and n columns 32·J … 32·J + 31, chunk c of node m at chunk_at(m, c)."""
    rng = np.random.default_rng(slice_index)
    w = torch.from_numpy(rng.standard_normal((N, H, 3 * H), dtype=np.float32))
    packed = rollout.pack_rollout_bank(w)
    assert packed.shape == (H // SLICE, H * N * 3 * SLICE) and packed.is_contiguous()
    stages = packed[slice_index].reshape(H // K_ROWS, K_ROWS, N, 3 * SLICE // 4, 4)
    cols = torch.arange(3 * SLICE)
    gate_col = (cols // SLICE) * H + slice_index * SLICE + cols % SLICE  # r | z | n
    for m in range(N):
        at = torch.tensor([_chunk_at(m, c) for c in range(3 * SLICE // 4)])
        row = stages[:, :, m][:, :, at].reshape(H // K_ROWS, K_ROWS, 3 * SLICE)
        assert torch.equal(row.reshape(H, 3 * SLICE), w[m][:, gate_col])


def test_product_threads_load_distinct_bank_groups():
    """The product threads (12 a node, thread ps of node m loading chunks ps
    and ps + 12 of the node's row of the stage) hit 8 distinct 16-byte bank
    groups in every 8-thread phase of a 16-byte load: the swap of odd nodes'
    chunk halves makes it so; without it two nodes in one phase collide."""
    def groups(swizzled):
        bad = 0
        for warp in range(8):
            for u in (0, 1):
                for phase in range(4):
                    tids = [32 * warp + 8 * phase + i for i in range(8)]
                    tids = [t for t in tids if t < N * 12]
                    chunk = [(t // 12) * 24 + ((_chunk_at(t // 12, t % 12 + 12 * u)) if swizzled
                                               else t % 12 + 12 * u) for t in tids]
                    bad += len({c % 8 for c in chunk}) != len(chunk)
        return bad
    assert groups(True) == 0 and groups(False) > 0


def test_packed_rollout_bank_is_cached_until_the_bank_changes():
    w = torch.randn(N, H, 3 * H)
    first = rollout.pack_rollout_bank(w)
    assert rollout.pack_rollout_bank(w) is first
    w.mul_(2)  # in place: a new version of the bank
    again = rollout.pack_rollout_bank(w)
    assert again is not first and torch.equal(again, 2 * first)


@pytest.mark.parametrize("shape", [(N, 48, 144), (N, H, 2 * H)], ids=["h48", "not-3h"])
def test_pack_rollout_bank_refuses_other_widths(shape):
    with pytest.raises(ValueError, match="is not \\[N, H, 3H\\]"):
        rollout.pack_rollout_bank(torch.zeros(shape))


def _inputs(rng, b):
    r = lambda *s, sc=0.3: torch.from_numpy(sc * rng.standard_normal(s, dtype=np.float32))  # noqa
    g = lambda: l1_normalize_rows(torch.eye(N) + 0.2 * torch.from_numpy(  # noqa: E731
        rng.random((N, N), dtype=np.float32)))
    return dict(cx=r(N, b, 3 * H), h0=r(N, b, H, sc=0.5), w_hh=r(N, H, 3 * H, sc=0.1),
                b_hh=r(N, 3 * H), g0=g(), g_add=r(N, N, sc=0.05), w_fc=r(N, H, F), b_fc=r(N, F),
                g_fc=g())


def test_wrapper_hands_the_kernel_the_packed_bank_and_the_plan(monkeypatch):
    calls = []

    def recording(library, symbol, n_pointers, n_ints):
        def entry(*args):
            calls.append((library, symbol, args[:n_pointers], args[n_pointers:-1]))
            return 0
        return entry

    monkeypatch.setattr(build, "kernel_device", lambda **tensors: "cuda")
    monkeypatch.setattr(build, "c_entry", recording)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    inp = _inputs(np.random.default_rng(0), b=4)
    before = rollout.launches
    out = rollout.gru_rollout(**inp, ph=5)
    assert rollout.launches == before + 1 and out.shape == (5, N, 4, F)
    (library, symbol, pointers, ints), = calls
    assert (library, symbol) == ("gru_rollout", "gru_rollout_f32")
    assert ints == (N, 4, H, F, 5, *rollout.rollout_plan(N, H))
    want = [rollout.pack_rollout_bank(t).data_ptr() if k == "w_hh" else t.data_ptr()
            for k, t in inp.items()] + [out.data_ptr()]
    assert list(pointers) == want


def _rollout_as_the_kernel_sums(cx, h0, w_hh, b_hh, g0, g_add, w_fc, b_fc, g_fc, *, ph):
    """The rollout with the kernel's association of the gate sums: r and z
    mixed once over cx + (h·W_hh + b_hh), n's two parts mixed apart."""
    h, g = h0, g0
    ys = []
    for _ in range(ph):
        p = gmm_nm(h, w_hh) + b_hh[:, None, :]
        r_z = gmix_nm(g, cx[..., :2 * H] + p[..., :2 * H])
        r, z = torch.sigmoid(r_z[..., :H]), torch.sigmoid(r_z[..., H:])
        n = torch.tanh(gmix_nm(g, cx[..., 2 * H:]) + r * gmix_nm(g, p[..., 2 * H:]))
        h = n - n * z + z * h
        ys.append(torch.tanh(gmix_nm(g_fc, gmm_nm(h, w_fc) + b_fc[:, None, :])))
        g = l1_normalize_rows(g + g_add)
    return torch.stack(ys)


def test_the_kernels_association_stays_within_its_margin_over_120_steps():
    """chip_smoke holds K1 at 1e-4 of the plain version over 120 steps; the
    kernel's own association of the r and z sums moves the outputs by less
    than 1e-5 here."""
    inp = _inputs(np.random.default_rng(1), b=16)
    want = rollout.gru_rollout_plain(**inp, ph=120)
    got = _rollout_as_the_kernel_sums(**inp, ph=120)
    assert got.shape == want.shape == (120, N, 16, F)
    assert (got - want).abs().max().item() < 1e-5


def test_resident_clusters_asks_the_c_entry_under_the_plan(monkeypatch):
    """The occupancy query names the library's C entry with the plan's stages
    and bytes and returns the count the entry writes; a failed query raises."""
    import ctypes

    calls = []

    def entry_of(library, symbol, n_pointers, n_ints):
        def entry(out, stages, smem_bytes, stream):
            calls.append((library, symbol, n_pointers, n_ints, stages, smem_bytes))
            ctypes.c_int.from_address(out).value = 30
            return 0
        return entry

    monkeypatch.setattr(build, "c_entry", entry_of)
    plan = rollout.rollout_plan(N, H)
    assert rollout.resident_clusters(plan) == 30
    assert calls == [("gru_rollout", "gru_rollout_f32_clusters", 1, 2, plan.stages,
                      plan.smem_bytes)]
    # the source's entry takes that pointer and those ints, and the stream
    source = (build.CSRC_DIR / "gru_rollout.cu").read_text()
    head = 'extern "C" int gru_rollout_f32_clusters('
    params = source[source.index(head) + len(head):].split(")", 1)[0].split(",")
    assert [("*" in q, q.split()[0]) for q in params] == [
        (True, "int*"), (False, "int"), (False, "int"), (True, "void*")]
    monkeypatch.setattr(build, "c_entry", lambda *a: (lambda *args: 1))
    with pytest.raises(RuntimeError, match="occupancy query.*cudaError 1"):
        rollout.resident_clusters(plan)
