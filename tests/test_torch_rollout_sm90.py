"""The host side of K1, the fp32 decode rollout (``csrc/gru_rollout.cu``),
and of B8, the merged-gate bf16 rollout (``csrc/gru_rollout_merged.cu``):
their plans, the W_hh banks packed into the rings' stages, the wrappers'
calls of the C entries, and K1's reassociated gate sums against the plain
version (B8's order of sums is held against the Pallas kernel in
``test_torch_decode_bf16.py``).  The kernels themselves run only on the card,
where ``chip_smoke.py`` holds each against its plain version at 12 800,
12 795 and 12 760 rows.
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


# "h48": a width the kernel does not take; 48 itself was until K1 took every
# multiple of 16 from 16 to 128 (tests/test_torch_small_models.py), so the
# case now asks for 40
@pytest.mark.parametrize("shape", [(N, 40, 120), (N, H, 2 * H)], ids=["h48", "not-3h"])
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

    def recording(library, symbol, n_pointers, n_ints, nodes=21, hidden=build.DEFAULT_HIDDEN):
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

    def entry_of(library, symbol, n_pointers, n_ints, nodes=21, hidden=build.DEFAULT_HIDDEN):
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


# ---- B8: the merged-gate bf16 rollout ---------------------------------------

S16, KR16 = rollout.ROLLOUT_BF16_SLICE, rollout.ROLLOUT_BF16_K_ROWS


def _bf16_layout_bytes():
    """One block's shared memory, piece by piece as ``Layout`` in
    ``csrc/gru_rollout_merged.cu`` places it."""
    barriers = 128                                  # 2 full, 2 empty, cx_full, cx_free, zeros
    ring = 2 * N * KR16 * 3 * S16 * 2               # 16 bank rows × nodes × r|z|n columns
    h32 = 4 * (H // S16) * 8 * 3 * 32 * 4           # a float4 a lane, 3 tiles, per slice, warp
    hb = N * (8 * 2 * (H + 8) + 16)                 # bf16(h), rows 8 values on, planes 16 bytes
    gates = 2 * N * (8 * 2 * (3 * S16 + 8) + 16)    # the slice's hw3 and cx
    fc = N * (H // KR16) * 12 * 8                   # W_fcᵀ fragments of lanes 0–11
    g = 4 * 3 * N * 24                              # G_t, G_add, G_fc
    q = 4 * N * 8 * F                               # the head's outputs
    return barriers + ring + h32 + hb + gates + fc + g + q


def test_bf16_plan_is_the_documented_one():
    plan = rollout.rollout_bf16_plan(N, H, F)
    assert tuple(plan) == (8, 16, 2, 2, 232112)
    assert plan.smem_bytes == _bf16_layout_bytes() <= engine.MAX_SMEM
    # each weight byte from L2 serves the cluster's 16 rows; a block's part of
    # a stage is whole 16-byte chunks; a warp's mix of the slice before comes
    # before its release of stage 1, and the ring is short enough that no
    # warp writes the slice's hw3 before every warp has read the last one
    stage = N * KR16 * 3 * S16 * 2
    assert plan.rows * plan.cluster == 16 and stage % (16 * plan.cluster) == 0
    assert plan.stages <= H // KR16 - 2


def _bf16_chunk_at(k, c):
    """Where the packed bf16 stage keeps 16-byte chunk c of bank row k."""
    return c ^ ((k >> 2) & 1)


@pytest.mark.parametrize("slice_index", range(H // S16))
def test_each_stage_of_the_bf16_bank_is_the_bank_rows_the_kernel_reads(slice_index):
    """Stage ks of slice J is bank rows 16·ks … 16·ks + 15 of every node, each
    the node's r, z and n columns 16·J … 16·J + 15, chunk c of row k at
    _bf16_chunk_at(k, c), where the kernel's ldmatrix reads it."""
    rng = np.random.default_rng(slice_index)
    w = torch.from_numpy(rng.standard_normal((N, H, 3 * H), dtype=np.float32)).to(torch.bfloat16)
    packed = rollout.pack_rollout_bank_bf16(w)
    assert packed.shape == (H // S16, H * N * 3 * S16) and packed.is_contiguous()
    assert packed.dtype == torch.bfloat16
    stages = packed[slice_index].reshape(H // KR16, N, KR16, 3 * S16 // 8, 8)
    cols = torch.arange(3 * S16)
    gate_col = (cols // S16) * H + slice_index * S16 + cols % S16  # r | z | n
    for ks in range(H // KR16):
        for k in range(KR16):
            at = torch.tensor([_bf16_chunk_at(k, c) for c in range(3 * S16 // 8)])
            got = stages[ks, :, k][:, at].reshape(N, 3 * S16)
            assert torch.equal(got, w[:, KR16 * ks + k][:, gate_col]), (ks, k)


def test_bf16_stage_reads_hit_distinct_bank_groups():
    """Each 8-lane phase of the products' ldmatrix.x4.trans (matrix i: bank
    rows k = lane%8 + 8·(i/2), the 16-byte chunk 2a + i%2 of gate a) reads 8
    distinct 16-byte bank groups of the stage: the chunk swap of rows with bit
    2 set makes it so; without it rows k and k + 4 collide."""
    def collisions(swizzled):
        bad = 0
        for node in range(N):
            for a in range(3):
                for i in range(4):
                    ks = [r + 8 * (i // 2) for r in range(8)]
                    c = 2 * a + i % 2
                    addr = [node * KR16 * 3 * S16 * 2 + k * 3 * S16 * 2
                            + 16 * (_bf16_chunk_at(k, c) if swizzled else c) for k in ks]
                    bad += len({(x // 16) % 8 for x in addr}) != 8
        return bad
    assert collisions(True) == 0 and collisions(False) > 0


def test_bf16_gate_buffers_are_read_and_written_without_bank_conflicts():
    """The mix's ldmatrix.trans reads one 16-byte row of 8 node planes at the
    same (row, column) (planes 912 bytes apart: distinct bank groups), and the
    products' 2-byte stores of hw3 (lane: gate column g = lane/4, row 2·(lane%4),
    rows 112 bytes apart) touch 16 distinct words in distinct banks; bf16(h)'s
    ldmatrix rows (208 bytes apart) and the gate update's stores into it (a
    warp a row, nodes 2·(lane%4) (+1) of a tile, planes 1 680 bytes apart) too."""
    plane, row, hb_plane, hb_row = 8 * 112 + 16, 112, 8 * 208 + 16, 208
    assert all(len({((k0 + k) * plane // 16) % 8 for k in range(8)}) == 8 for k0 in range(14))
    words = {(2 * (l % 4) * row + 2 * (l // 4)) // 4 for l in range(32)}
    assert len(words) == 16 and len({w % 32 for w in words}) == 16
    assert len({(r * hb_row // 16) % 8 for r in range(8)}) == 8
    for e in range(2):  # the two nodes of a lane's pair
        words = {((2 * (l % 4) + e) * hb_plane + 2 * (l // 4)) // 4 for l in range(32)}
        assert len(words) == 16 and len({w % 32 for w in words}) == 16


def test_packed_bf16_bank_is_cached_until_the_bank_changes():
    w = torch.randn(N, H, 3 * H).to(torch.bfloat16)
    first = rollout.pack_rollout_bank_bf16(w)
    assert rollout.pack_rollout_bank_bf16(w) is first
    w.mul_(2)  # in place: a new version of the bank
    again = rollout.pack_rollout_bank_bf16(w)
    assert again is not first and torch.equal(again, 2 * first)
    # the fp32 kernel's packing of the same bank is a different cache entry
    assert rollout.pack_rollout_bank(w.float()) is not again


@pytest.mark.parametrize("shape", [(N, 40, 120), (N, H, 2 * H)], ids=["h40", "not-3h"])
def test_pack_rollout_bank_bf16_refuses_other_widths(shape):
    with pytest.raises(ValueError, match="is not \\[N, H, 3H\\]"):
        rollout.pack_rollout_bank_bf16(torch.zeros(shape, dtype=torch.bfloat16))


def test_bf16_wrapper_hands_the_kernel_the_packed_bank_and_the_plan(monkeypatch):
    calls = []

    def recording(library, symbol, n_pointers, n_ints, nodes=21):
        def entry(*args):
            calls.append((library, symbol, args[:n_pointers], args[n_pointers:-1]))
            return 0
        return entry

    monkeypatch.setattr(build, "kernel_device", lambda **tensors: "cuda")
    monkeypatch.setattr(build, "c_entry", recording)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    inp = {k: v.to(torch.bfloat16) if k in ("cx", "w_hh", "w_fc") else v
           for k, v in _inputs(np.random.default_rng(0), b=4).items()}
    before = rollout.launches_bf16
    out = rollout.gru_rollout(**inp, ph=5, compute_dtype=torch.bfloat16)
    assert rollout.launches_bf16 == before + 1 and out.shape == (5, N, 4, F)
    (library, symbol, pointers, ints), = calls
    assert (library, symbol) == ("gru_rollout_merged", "gru_rollout_bf16")
    assert ints == (N, 4, H, F, 5, *rollout.rollout_bf16_plan(N, H, F))
    want = [rollout.pack_rollout_bank_bf16(t).data_ptr() if k == "w_hh" else t.data_ptr()
            for k, t in inp.items()] + [out.data_ptr()]
    assert list(pointers) == want
