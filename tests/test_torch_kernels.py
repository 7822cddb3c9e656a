"""The port's kernel modules against the JAX package, on the CPU: the
wrappers take their plain versions here, and the Pallas kernels run in
interpret mode, as the JAX package's own tests run them.  Plain emulations
of the CUDA kernels' schedules (the flood's, cc's, ladder A's grid) are
held against both."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import t3dct_torch  # noqa: F401
from t3dct.models import layers as JL
from t3dct.ops.pallas_conv import conv3x3x3_fused
from t3dct.ops.pallas_kernels import _BIG, cc_propagate
from t3dct.ops.pallas_kernels import flood_slices as jflood_slices
from t3dct.ops.watershed import watershed_flood as jwatershed_flood
from t3dct_torch.models import layers as L
from t3dct_torch.ops.hopper_conv import (conv3x3x3_bias_relu,
                                         conv3x3x3_bias_relu_plain)
from t3dct_torch.ops import hopper_cc, hopper_flood, ladder
from t3dct_torch.ops.hopper_flood import flood_slices, flood_slices_plain
from t3dct_torch.ops.watershed import watershed_flood
from t3dct_torch.utils.synthetic import serpentine


def _conv_bound(ref):
    # f32 accumulation in a different summation order
    return 1e-5 * float(np.abs(ref).max()) + 1e-6


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(4, 12, 10, 1, 8), (4, 12, 10, 8, 16),
                                   (3, 6, 21, 24, 32)])
def test_conv_plain_matches_pallas_and_layers(shape, relu):
    z, y, x, ci, co = shape
    rng = np.random.RandomState(ci + co)
    xin = rng.randn(z, y, x, ci).astype(np.float32)
    w = (rng.randn(3, 3, 3, ci, co) / np.sqrt(27 * ci)).astype(np.float32)
    b = (rng.randn(co) * 0.1).astype(np.float32)
    want_pallas = np.asarray(conv3x3x3_fused(
        jnp.asarray(xin), jnp.asarray(w), jnp.asarray(b), relu=relu))
    want_layers = np.asarray(JL.conv3d(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)},
        jnp.asarray(xin)[None]))[0]
    if relu:
        want_layers = np.maximum(want_layers, 0.0)
    tx, tw, tb = (torch.from_numpy(a) for a in (xin, w, b))
    got = conv3x3x3_bias_relu(tx, tw, tb, relu=relu).numpy()
    np.testing.assert_array_equal(
        got, conv3x3x3_bias_relu_plain(tx, tw, tb, relu=relu).numpy())
    for want in (want_pallas, want_layers):
        assert np.abs(got - want).max() <= _conv_bound(want)
    # the layer entry point (batched, channels-last) takes the same path
    lay = L.conv3d({"w": tw, "b": tb}, tx[None], relu=relu)[0].numpy()
    np.testing.assert_array_equal(lay, got)


def _flood_case(seed, x=24, y=30, z=3, levels=None):
    rng = np.random.RandomState(seed)
    seg = np.zeros((x, y, z), np.int32)
    seg[4:9, 4:9, :] = 1
    seg[14:19, 20:26, :] = 2
    seg[3:6, 22:27, 1:] = 3
    mask = np.zeros((x, y, z), bool)
    mask[2:22, 2:28, :] = True
    if levels is None:
        elev = rng.rand(x, y, z).astype(np.float32)
    else:   # few distinct elevations: many exact (cost, hops) ties
        elev = rng.randint(0, levels, (x, y, z)).astype(np.float32)
    return elev, seg, mask


@pytest.mark.parametrize("levels", [None, 3, 1])
def test_flood_plain_matches_pallas_and_watershed(levels, monkeypatch):
    elev, seg, mask = _flood_case(levels or 7, levels=levels)
    want = np.asarray(jflood_slices(jnp.asarray(elev), jnp.asarray(seg),
                                    jnp.asarray(mask)))
    want_ws = np.asarray(jax.vmap(
        lambda e, mk, m: jwatershed_flood(e, mk, m, 1),
        in_axes=2, out_axes=2)(jnp.asarray(elev), jnp.asarray(seg),
                               jnp.asarray(mask)))
    np.testing.assert_array_equal(want, want_ws)
    te, ts, tm = (torch.from_numpy(a) for a in (elev, seg, mask))
    got, rounds = flood_slices(te, ts, tm)
    np.testing.assert_array_equal(got.numpy(), want)
    # the host's check interval does not change the labels (fixed point)
    monkeypatch.setattr(hopper_flood, "CHECK_EVERY", 3)
    got_plain, _ = flood_slices_plain(te, ts, tm)
    np.testing.assert_array_equal(got_plain.numpy(), want)
    assert 0 < rounds <= 512


def _kernel_schedule(elev, markers, mask, max_iters, tile):
    """A plain numpy emulation of csrc/flood.cu's schedule: (x, y, z)
    layout; rounds that write only updatable voxels of listed tiles (flat
    runs of ``tile`` voxels holding one) in slices whose last round changed
    something, with a convergence check every round; the state of a voxel
    that is not updatable read from the inputs; the ping-pong sets never
    initialised (filled here with values that would win if read); each
    slice's labels taken from the set its last round wrote.  Returns
    (labels, rounds run, tiles listed)."""
    inf = np.float32(3e38)
    m = mask != 0
    is_marker = m & (markers > 0)
    upd = m & ~is_marker
    fixed = (np.where(is_marker, markers, 0).astype(np.int32),
             np.where(is_marker, elev, inf).astype(np.float32),
             np.where(is_marker, 0.0, inf).astype(np.float32))
    start = (np.int32(0), inf, inf)
    sets = [[np.full(elev.shape, v, t) for v, t in
             ((12345, np.int32), (-1.0, np.float32), (-1.0, np.float32))]
            for _ in range(2)]
    flat = np.concatenate((upd.ravel(), np.zeros(-upd.size % tile, bool)))
    listed = flat.reshape(-1, tile).any(axis=1)
    visit = np.repeat(listed, tile)[:upd.size].reshape(upd.shape) & upd
    live = np.ones(elev.shape[2], bool)
    ran = np.full(elev.shape[2], -1)
    fills = (0, inf, inf)

    def neighbour(v, axis, d, fill):
        out = np.full_like(v, fill)
        src = [slice(None)] * 3
        dst = [slice(None)] * 3
        src[axis], dst[axis] = ((slice(None, -1), slice(1, None)) if d < 0
                                else (slice(1, None), slice(None, -1)))
        out[tuple(dst)] = v[tuple(src)]
        return out

    r = 0
    while r < max_iters:
        lab, cost, hops = (np.where(upd, st if r == 0 else cur, fx)
                           for st, cur, fx in zip(start, sets[r % 2], fixed))
        bl, bc, bh = lab.copy(), cost.copy(), hops.copy()
        for axis, d in ((0, -1), (1, -1), (1, 1), (0, 1)):  # x-1 y-1 y+1 x+1
            nl, nc, nh = (neighbour(v, axis, d, f)
                          for v, f in zip((lab, cost, hops), fills))
            cc = np.maximum(nc, elev)
            ch = nh + np.float32(1.0)
            better = (nl > 0) & ((cc < bc) | ((cc == bc) & (ch < bh)))
            bl = np.where(better, nl, bl)
            bc = np.where(better, cc, bc)
            bh = np.where(better, ch, bh)
        act = visit & live[None, None, :]
        moved = act & ((bl != lab) | (bc != cost) | (bh != hops))
        for dst, src in zip(sets[(r + 1) % 2], (bl, bc, bh)):
            dst[act] = src[act]
        ran[act.any(axis=(0, 1))] = r + 1
        r += 1
        live = moved.any(axis=(0, 1))
        if not live.any():
            break
    last = np.stack([sets[0][0], sets[1][0]])[ran % 2, :, :,
                                              np.arange(len(ran))]
    labels = np.where(upd, last.transpose(1, 2, 0) if r > 0 else 0,
                      fixed[0])
    return np.where(m, labels, 0), r, int(listed.sum())


@pytest.mark.parametrize("max_iters", [1, 7, 512])
@pytest.mark.parametrize("levels", [None, 3, 1])
def test_flood_kernel_schedule_matches_plain_and_jax(levels, max_iters,
                                                     monkeypatch):
    """The kernel's schedule (only listed tiles, converged slices dropped,
    a check every round) gives the plain version's and JAX's labels
    exactly, at the cap too, and stops at the plain version's round when
    that checks every round."""
    elev, seg, mask = _flood_case(11 + (levels or 0), levels=levels)
    mask[:, :, 2] = False                     # an empty slice
    want = np.asarray(jflood_slices(jnp.asarray(elev), jnp.asarray(seg),
                                    jnp.asarray(mask), max_iters=max_iters))
    monkeypatch.setattr(hopper_flood, "CHECK_EVERY", 1)
    te, ts, tm = (torch.from_numpy(a) for a in (elev, seg, mask))
    plain, rounds_p = flood_slices_plain(te, ts, tm, max_iters=max_iters)
    for tile in (64, hopper_flood.TILE):
        got, rounds, listed = _kernel_schedule(elev, seg, mask, max_iters,
                                               tile)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, plain.numpy())
        assert rounds == rounds_p
        assert listed == hopper_flood.active_tiles(ts, tm, tile)


@pytest.mark.parametrize("tile", [1, 7, 64, 1024])
@pytest.mark.parametrize("case", ["overlaps", "empty", "markers only",
                                  "dense"])
def test_active_tiles_matches_brute_force(case, tile):
    """The count of tiles the flood kernel lists, against a loop over the
    flat (x, y, z) index."""
    rng = np.random.RandomState(tile)
    shape = (13, 11, 5)
    markers = np.where(rng.rand(*shape) < 0.3,
                       rng.randint(1, 4, shape), 0).astype(np.int32)
    mask = {"overlaps": rng.rand(*shape) < 0.05,
            "empty": np.zeros(shape, bool),
            "markers only": markers > 0,
            "dense": np.ones(shape, bool)}[case]
    upd = (mask & ~(markers > 0)).ravel()
    want = sum(bool(upd[t:t + tile].any()) for t in range(0, upd.size, tile))
    got = hopper_flood.active_tiles(torch.from_numpy(markers),
                                    torch.from_numpy(mask), tile)
    assert got == want


def test_flood_round_cap_matches_jax():
    """Stopped by the cap before the fixed point, both stop at the same
    round (the host checks every few rounds but never runs past the cap)."""
    elev, seg, mask = _flood_case(3, x=40, y=40, z=2)
    want = np.asarray(jax.vmap(
        lambda e, mk, m: jwatershed_flood(e, mk, m, 1, max_iters=7),
        in_axes=2, out_axes=2)(jnp.asarray(elev), jnp.asarray(seg),
                               jnp.asarray(mask)))
    got, rounds = flood_slices(*(torch.from_numpy(a)
                                 for a in (elev, seg, mask)), max_iters=7)
    assert rounds == 7
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("conn", [1, 2])
def test_watershed_flood_3d_matches_jax(conn):
    rng = np.random.RandomState(5)
    elev = rng.rand(14, 12, 6).astype(np.float32)
    markers = np.zeros((14, 12, 6), np.int32)
    markers[2, 2, 1], markers[11, 9, 4], markers[6, 10, 2] = 1, 2, 3
    mask = rng.rand(14, 12, 6) < 0.9
    want = np.asarray(jwatershed_flood(jnp.asarray(elev),
                                       jnp.asarray(markers),
                                       jnp.asarray(mask), conn))
    got = watershed_flood(torch.from_numpy(elev), torch.from_numpy(markers),
                          torch.from_numpy(mask), conn)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- connected components: csrc/cc.cu's schedule ---------------------------

def _cc_offsets(per_slice):
    """The forward half of the neighbourhood, in the kernel's loop order."""
    if per_slice:
        return [(0, 1, 0), (1, -1, 0), (1, 0, 0), (1, 1, 0)]
    return [(dx, dy, dz) for dx in (0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1) if (dx, dy, dz) > (0, 0, 0)]


def test_cc_forward_offsets_table():
    """csrc/cc.cu's packed table of forward offsets, decoded: the 13 of
    26-connectivity in lexicographic order, then the 4 of a slice's
    8-connectivity."""
    src = (Path(hopper_cc.__file__).parents[1] / "csrc" / "cc.cu").read_text()
    body = re.search(r"kForward\[17\] = \{([^}]*)\}", src).group(1)
    packed = [int(v, 16) for v in re.findall(r"0x[0-9a-f]+", body)]
    offsets = [((o >> 4) - 1, ((o >> 2) & 3) - 1, (o & 3) - 1)
               for o in packed]
    assert offsets == _cc_offsets(False) + _cc_offsets(True)


def _cc_tiles(shape, plan):
    """The kernel's tile_of for every tile id: (x0, y0, z0, tx, ty, tz)."""
    (tx, ty, tz), _ = plan
    nty, ntz = -(-shape[1] // ty), -(-shape[2] // tz)
    out = []
    for t in range(plan[1]):
        iz, r = t % ntz, t // ntz
        iy, ix = r % nty, r // nty
        x0, y0, z0 = ix * tx, iy * ty, iz * tz
        out.append((x0, y0, z0, min(tx, shape[0] - x0),
                    min(ty, shape[1] - y0), min(tz, shape[2] - z0)))
    return out


def _cc_schedule(mask, per_slice, resident, tile_max):
    """A plain emulation of csrc/cc.cu, phase by phase: the host's tile
    plan; per tile, unions of the internal forward edges with the smaller
    root winning, flattened, every entry its tile-local root's label
    (1-based, the mode's numbering: the entry is the parent pointer); the
    unions across the tiles' forward faces on the encoded entries; every
    entry pointed at its root.  The kernel runs the unions of a phase
    concurrently; any order gives the same fixed point."""
    X, Y, Z = mask.shape
    plan = hopper_cc.tile_plan((X, Y, Z), resident, tile_max)
    m = mask.ravel()
    out = np.zeros(m.size, np.int64)

    def flat(x, y, z):
        return (x * Y + y) * Z + z

    def enc(g):
        return g // Z + 1 if per_slice else g + 1

    def dec(e, z):
        return (e - 1) * Z + z if per_slice else e - 1

    def root(g, z):
        while dec(out[g], z) != g:
            g = dec(out[g], z)
        return g

    offsets = _cc_offsets(per_slice)
    tiles = _cc_tiles(mask.shape, plan)
    for x0, y0, z0, tx, ty, tz in tiles:                       # phase 1
        n = tx * ty * tz
        co = [(l // (ty * tz), l // tz % ty, l % tz) for l in range(n)]
        lp = [l if m[flat(x0 + a, y0 + b, z0 + c)] else -1
              for l, (a, b, c) in enumerate(co)]

        def lroot(i):
            while lp[i] != i:
                i = lp[i]
            return i

        for l, (lx, ly, lz) in enumerate(co):
            if lp[l] < 0:
                continue
            for dx, dy, dz in offsets:
                if lx + dx < tx and 0 <= ly + dy < ty and 0 <= lz + dz < tz:
                    j = l + (dx * ty + dy) * tz + dz
                    if lp[j] >= 0:
                        a, b = sorted((lroot(l), lroot(j)))
                        lp[b] = a
        for l, (lx, ly, lz) in enumerate(co):
            r = lroot(l) if lp[l] >= 0 else None
            out[flat(x0 + lx, y0 + ly, z0 + lz)] = 0 if r is None else enc(
                flat(x0 + co[r][0], y0 + co[r][1], z0 + co[r][2]))
    for x0, y0, z0, tx, ty, tz in tiles:                       # phase 2
        for l in range(tx * ty * tz):
            lx, ly, lz = l // (ty * tz), l // tz % ty, l % tz
            x, y, z = x0 + lx, y0 + ly, z0 + lz
            face = ((lx == tx - 1 and x + 1 < X)
                    or (ly == ty - 1 and y + 1 < Y)
                    or (ly == 0 and y > 0 and x + 1 < X)
                    or (not per_slice and ((lz == tz - 1 and z + 1 < Z)
                                           or (lz == 0 and z > 0))))
            g = flat(x, y, z)
            if not face or not m[g]:
                continue
            for dx, dy, dz in offsets:
                xx, yy, zz = x + dx, y + dy, z + dz
                if not (xx < X and 0 <= yy < Y and 0 <= zz < Z):
                    continue
                if lx + dx < tx and 0 <= ly + dy < ty and 0 <= lz + dz < tz:
                    continue
                j = flat(xx, yy, zz)
                if m[j]:
                    a, b = sorted((root(g, z), root(j, z)))
                    if a != b:
                        out[b] = enc(a)
    for i in range(m.size):                                    # phase 3
        if out[i]:
            out[i] = enc(root(i, i % Z if per_slice else 0))
    return out.reshape(mask.shape), plan


def _cc_jax(mask, per_slice):
    """JAX's cc_propagate (interpret mode on the CPU) on the kernel's
    contract: min-propagated initial labels, slice by slice per slice."""
    def one(mk):
        init = np.where(mk, np.arange(1, mk.size + 1, dtype=np.int32)
                        .reshape(mk.shape), _BIG)
        lab = np.asarray(cc_propagate(jnp.asarray(init), max_iters=512))
        return np.where(lab == _BIG, 0, lab)
    if not per_slice:
        return one(mask)
    return np.stack([one(mask[:, :, z]) for z in range(mask.shape[2])], 2)


# (resident blocks, tile_max): the card's grid with the kernel's shared
# arrays, and small ones that force small, ragged tiles
CC_PLANS = [(1056, hopper_cc.TILE_MAX), (792, hopper_cc.TILE_MAX), (4, 150),
            (2, 37), (3, 5)]


@pytest.mark.parametrize("resident,tile_max", CC_PLANS)
@pytest.mark.parametrize("shape", [(401, 168, 24), (13, 11, 6), (61, 47, 9),
                                   (7, 1, 1), (1, 9, 1), (1, 1, 70),
                                   (3, 1000, 1), (20, 10, 130),
                                   (512, 512, 64)])
def test_cc_tile_plan_covers_every_voxel_once(shape, resident, tile_max):
    """The host's tiles cover the volume exactly once, each within
    ``tile_max`` voxels; a tile takes all of z up to TILE_Z_MAX; the
    resident blocks take one tile each unless even ``tile_max``-voxel
    tiles outnumber them; where the kernel reads 4-voxel words, every
    aligned group of a tile's local indices is 4 consecutive, aligned
    voxels."""
    plan = hopper_cc.tile_plan(shape, resident, tile_max)
    (tx, ty, tz), n_tiles = plan
    assert tx * ty * tz <= tile_max
    if tile_max >= hopper_cc.TILE_Z_MAX:
        assert tz == min(shape[2], hopper_cc.TILE_Z_MAX)
    if n_tiles > resident:
        assert (tx, ty, tz) == hopper_cc.tile_box(shape, tile_max)
    if tile_max == hopper_cc.TILE_MAX and np.prod(shape) <= resident * 256:
        assert tx * ty * tz <= max(256, np.prod(shape))
    seen = np.zeros(shape, np.int32)
    vec = shape[2] % 4 == 0 and (tz >= shape[2] or tz % 4 == 0)
    for x0, y0, z0, a, b, c in _cc_tiles(shape, plan):
        assert min(a, b, c) >= 1
        seen[x0:x0 + a, y0:y0 + b, z0:z0 + c] += 1
        if vec:
            assert c % 4 == 0
            l = np.arange(0, a * b * c, 4)
            g = ((x0 + l // (b * c)) * shape[1] + y0 + l // c % b) \
                * shape[2] + z0 + l % c
            assert (g % 4 == 0).all() and (l % c + 3 < c).all()
    assert (seen == 1).all()


def test_cc_tile_plan_at_the_pipeline_frame():
    """(401, 168, 24) on 132 SMs of 8 or 6 blocks: whole-z tiles of ~1.6-2.1
    thousand voxels, one a block."""
    for resident, box in ((1056, (9, 8, 24)), (792, (11, 8, 24))):
        (tx, ty, tz), n_tiles = hopper_cc.tile_plan((401, 168, 24), resident)
        assert (tx, ty, tz) == box and n_tiles <= resident


@pytest.mark.parametrize("resident,tile_max", CC_PLANS[:1] + CC_PLANS[2:4])
@pytest.mark.parametrize("case", ["sparse", "dense", "snake", "full"])
@pytest.mark.parametrize("per_slice", [False, True])
def test_cc_kernel_schedule_matches_plain_and_jax(per_slice, case, resident,
                                                  tile_max):
    """The kernel's schedule, emulated, gives JAX's cc_propagate labels and
    the plain version's exactly, with the card's plan (tiles of at least
    256 voxels: six here) and with tiles ragged on every axis."""
    shape = (13, 11, 6)
    rng = np.random.RandomState(len(case))
    mask = {"sparse": rng.rand(*shape) < 0.25,
            "dense": rng.rand(*shape) < 0.6,
            "snake": serpentine(shape),
            "full": np.ones(shape, bool)}[case]
    got, plan = _cc_schedule(mask, per_slice, resident, tile_max)
    assert plan[1] > 1
    np.testing.assert_array_equal(got, _cc_jax(mask, per_slice))
    plain = hopper_cc.cc_label(torch.from_numpy(mask), per_slice=per_slice)
    np.testing.assert_array_equal(got, plain.numpy())


@pytest.mark.parametrize("per_slice", [False, True])
def test_cc_kernel_schedule_across_many_tiles(per_slice):
    """A taller volume cut by z too (tz 4 of 10): the z-faces' unions."""
    mask = np.random.RandomState(9).rand(9, 8, 10) < 0.4
    got, plan = _cc_schedule(mask, per_slice, 2, 4)
    assert plan[0][2] == 4 and plan[1] > 20
    np.testing.assert_array_equal(got, _cc_jax(mask, per_slice))


# ---- ladder A: the add_one kernel's grid ------------------------------------

def _add_one_walk(n, n4, blocks, aligned):
    """How many times csrc/ladder.cu's add_one kernels write each float.
    Aligned: thread t of T takes float4s t, t + T, ... ADD_ONE_UNROLL at a
    time while a whole group fits, then one at a time, and threads 0-2 of
    block 0 the floats past the last float4.  Else every float is scalar:
    t, t + T, ..."""
    T = blocks * ladder.ADD_ONE_THREADS
    U = ladder.ADD_ONE_UNROLL
    seen = np.zeros(n, np.int64)
    t = np.arange(T)
    if not aligned:
        for k in range(0, n, T):
            np.add.at(seen, (k + t)[k + t < n], 1)
        return seen
    np.add.at(seen, 4 * n4 + t[:ladder.ADD_ONE_THREADS][
        t[:ladder.ADD_ONE_THREADS] < n - 4 * n4], 1)
    i = t.copy()
    while True:
        act = i + (U - 1) * T < n4
        if not act.any():
            break
        for u in range(U):
            for j in range(4):
                np.add.at(seen, 4 * (i[act] + u * T) + j, 1)
        i = np.where(act, i + U * T, i)
    while (i < n4).any():
        act = i < n4
        for j in range(4):
            np.add.at(seen, 4 * i[act] + j, 1)
        i = np.where(act, i + T, i)
    return seen


@pytest.mark.parametrize("resident", [1, 3, 132 * 8])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", [1, 3, 4, 7, 1024, 4097, 100003])
def test_add_one_plan_covers_every_float_once(n, aligned, resident):
    """The grid the host plans for ``n`` floats: every float written once
    (the unrolled body, the float4s left over, the tail past them; all
    scalar off a 16-byte line), at most ``resident`` blocks, and no block
    more than the work needs."""
    n4, blocks = ladder.add_one_plan(n, aligned, resident)
    assert n4 == (n // 4 if aligned else 0)
    assert 1 <= blocks <= resident
    work = max(n4, n - 4 * n4)
    assert (blocks - 1) * ladder.ADD_ONE_THREADS < work
    assert (_add_one_walk(n, n4, blocks, aligned) == 1).all()


def test_add_one_plan_at_the_probe_shape():
    """The probe's (24, 204, 84, 32) f32 input on 132 SMs of 8 blocks:
    the card's resident grid, every float once."""
    n = 24 * 204 * 84 * 32
    n4, blocks = ladder.add_one_plan(n, True, 132 * 8)
    assert (n4, blocks) == (n // 4, 132 * 8)
    assert (_add_one_walk(n, n4, blocks, True) == 1).all()
