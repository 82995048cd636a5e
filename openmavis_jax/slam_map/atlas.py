"""Atlas: the multi-map container with map spawning and merging.

JAX replacement for the reference's Atlas (reference: src/Atlas.cc —
set of Maps + current map; CreateNewMap on tracking loss Atlas.h:57;
abandoned maps re-joined by merge detection LoopClosing::MergeLocal/
MergeLocal2 src/LoopClosing.cc:1381/1956).

Maps are fixed-capacity MapState slabs; merging transforms the younger map
through a verified Sim3 and appends its keyframes/landmarks into the older
map's free slots with re-indexed observation ids — one batched scatter, no
pointer surgery.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import lie
from . import map_state as ms


@dataclass
class Atlas:
    maps: list = field(default_factory=list)   # list[ms.MapState]
    current: int = -1

    def create_map(self, max_kf, max_feat, max_mp) -> int:
        """CreateNewMap equivalent: returns the new map's index."""
        self.maps.append(ms.allocate(max_kf, max_feat, max_mp))
        self.current = len(self.maps) - 1
        return self.current

    @property
    def current_map(self) -> ms.MapState:
        return self.maps[self.current]

    @current_map.setter
    def current_map(self, m):
        self.maps[self.current] = m

    def n_maps(self):
        return len(self.maps)


def transform_map(m: ms.MapState, s, R, t) -> ms.MapState:
    """Apply a world-frame Sim3 (x -> s R x + t) to every pose/landmark."""
    Rn = lie.normalize_rotation(
        jnp.einsum("ij,kjl->kil", R, m.kf_R))
    tn = s * jnp.einsum("ij,kj->ki", R, m.kf_t) + t
    vn = s * jnp.einsum("ij,kj->ki", R, m.kf_v)
    pn = s * jnp.einsum("ij,mj->mi", R, m.mp_pos) + t
    return m._replace(kf_R=Rn, kf_t=tn, kf_v=vn, mp_pos=pn)


def merge_maps_device(dst: ms.MapState, src: ms.MapState, s, R, t):
    """Jit-traceable weld of `src` into `dst` (dst <- s R src + t).

    The device-resident form of `merge_maps` for the streaming cross-map
    merge (reference: MergeLocal2's stop-mapper -> transform -> weld
    sequence, src/LoopClosing.cc:1956-2130 — here one traced program with
    ZERO host reads): offsets are traced scalars, and every append is an
    extended-slab scatter whose out-of-capacity rows land in a dump slot.

    Returns (merged MapState, fits) — when `fits` is False the returned
    map is unchanged `dst` except for counters, so callers must gate on
    it (lax.cond / where).
    """
    K, F = dst.kf_obs.shape
    M = dst.mp_pos.shape[0]
    Ks = src.kf_obs.shape[0]
    Ms = src.mp_pos.shape[0]
    src_t = transform_map(src, s, R, t)
    kf_off = dst.n_kf
    mp_off = dst.n_mp
    fits = ((dst.n_kf + src.n_kf <= K)
            & (dst.n_mp + src.n_mp <= M))

    ks = jnp.arange(Ks)
    kf_tgt = jnp.where(fits & (ks < src.n_kf), kf_off + ks, K)
    md = jnp.arange(Ms)
    mp_tgt = jnp.where(fits & (md < src.n_mp), mp_off + md, M)

    def app_kf(d, s_):
        ext = jnp.concatenate([d, jnp.zeros_like(d[:1])], axis=0)
        return ext.at[kf_tgt].set(s_)[:K]

    def app_mp(d, s_):
        ext = jnp.concatenate([d, jnp.zeros_like(d[:1])], axis=0)
        return ext.at[mp_tgt].set(s_)[:M]

    src_obs = jnp.where(src_t.kf_obs >= 0, src_t.kf_obs + mp_off, -1)
    out = dst._replace(
        kf_R=app_kf(dst.kf_R, src_t.kf_R),
        kf_t=app_kf(dst.kf_t, src_t.kf_t),
        kf_v=app_kf(dst.kf_v, src_t.kf_v),
        kf_bg=app_kf(dst.kf_bg, src_t.kf_bg),
        kf_ba=app_kf(dst.kf_ba, src_t.kf_ba),
        kf_time=app_kf(dst.kf_time, src_t.kf_time),
        kf_valid=app_kf(dst.kf_valid, src_t.kf_valid),
        kf_xy=app_kf(dst.kf_xy, src_t.kf_xy),
        kf_desc=app_kf(dst.kf_desc, src_t.kf_desc),
        kf_level=app_kf(dst.kf_level, src_t.kf_level),
        kf_sigma2=app_kf(dst.kf_sigma2, src_t.kf_sigma2),
        kf_cam=app_kf(dst.kf_cam, src_t.kf_cam),
        kf_feat_valid=app_kf(dst.kf_feat_valid, src_t.kf_feat_valid),
        kf_obs=app_kf(dst.kf_obs, src_obs),
        kf_bow=app_kf(dst.kf_bow, src_t.kf_bow),
        mp_pos=app_mp(dst.mp_pos, src_t.mp_pos),
        mp_desc=app_mp(dst.mp_desc, src_t.mp_desc),
        mp_normal=app_mp(dst.mp_normal, src_t.mp_normal),
        mp_dmin=app_mp(dst.mp_dmin, s * src_t.mp_dmin),
        mp_dmax=app_mp(dst.mp_dmax, s * src_t.mp_dmax),
        mp_valid=app_mp(dst.mp_valid, src_t.mp_valid),
        mp_first_kf=app_mp(dst.mp_first_kf,
                           src_t.mp_first_kf + kf_off),
        mp_last_kf=app_mp(dst.mp_last_kf, src_t.mp_last_kf + kf_off),
        mp_visible=app_mp(dst.mp_visible, src_t.mp_visible),
        mp_found=app_mp(dst.mp_found, src_t.mp_found),
        n_kf=jnp.where(fits, dst.n_kf + src.n_kf, dst.n_kf),
        n_mp=jnp.where(fits, dst.n_mp + src.n_mp, dst.n_mp),
    )
    # carry src's persistent loop edges (slots shift by kf_off) into
    # dst's edge ring
    L = dst.loop_i.shape[0]

    def add_edge(carry, e):
        m_, = carry
        li, lj, lv = e
        m2_ = ms.add_loop_edge(m_, li + kf_off, lj + kf_off)
        m_ = _tree_where(lv & fits, m2_, m_)
        return (m_,), None

    (out,), _ = jax.lax.scan(
        add_edge, (out,),
        (src.loop_i, src.loop_j,
         src.loop_valid & (src.loop_i >= 0) & (src.loop_j >= 0)))
    return out, fits


def _tree_where(pred, a, b):
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)


def merge_maps(dst: ms.MapState, src: ms.MapState, s, R, t):
    """Weld `src` into `dst`: src is moved by the Sim3 (dst <- s R src + t)
    and its keyframes/landmarks appended into dst's free capacity.

    (reference: LoopClosing::MergeLocal migrates KFs/MPs between maps,
    src/LoopClosing.cc:1381; here it is one re-indexed concatenation.)
    Returns (merged MapState, ok) — ok False if capacity is insufficient.
    """
    src_t = transform_map(src, s, R, t)
    K, F = dst.kf_obs.shape
    M = dst.mp_pos.shape[0]
    n_kf_d = int(dst.n_kf)
    n_kf_s = int(src.n_kf)
    n_mp_d = int(dst.n_mp)
    n_mp_s = int(src.n_mp)
    if n_kf_d + n_kf_s > K or n_mp_d + n_mp_s > M:
        return dst, False

    kf_off = n_kf_d
    mp_off = n_mp_d
    ks = jnp.arange(n_kf_s)
    md = jnp.arange(n_mp_s)

    # re-index src observations into dst landmark ids
    src_obs = src_t.kf_obs[:n_kf_s]
    src_obs = jnp.where(src_obs >= 0, src_obs + mp_off, -1)

    out = dst._replace(
        kf_R=dst.kf_R.at[kf_off:kf_off + n_kf_s].set(src_t.kf_R[:n_kf_s]),
        kf_t=dst.kf_t.at[kf_off:kf_off + n_kf_s].set(src_t.kf_t[:n_kf_s]),
        kf_v=dst.kf_v.at[kf_off:kf_off + n_kf_s].set(src_t.kf_v[:n_kf_s]),
        kf_bg=dst.kf_bg.at[kf_off:kf_off + n_kf_s].set(
            src_t.kf_bg[:n_kf_s]),
        kf_ba=dst.kf_ba.at[kf_off:kf_off + n_kf_s].set(
            src_t.kf_ba[:n_kf_s]),
        kf_time=dst.kf_time.at[kf_off:kf_off + n_kf_s].set(
            src_t.kf_time[:n_kf_s]),
        kf_valid=dst.kf_valid.at[kf_off:kf_off + n_kf_s].set(
            src_t.kf_valid[:n_kf_s]),
        kf_xy=dst.kf_xy.at[kf_off:kf_off + n_kf_s].set(
            src_t.kf_xy[:n_kf_s]),
        kf_desc=dst.kf_desc.at[kf_off:kf_off + n_kf_s].set(
            src_t.kf_desc[:n_kf_s]),
        kf_level=dst.kf_level.at[kf_off:kf_off + n_kf_s].set(
            src_t.kf_level[:n_kf_s]),
        kf_sigma2=dst.kf_sigma2.at[kf_off:kf_off + n_kf_s].set(
            src_t.kf_sigma2[:n_kf_s]),
        kf_cam=dst.kf_cam.at[kf_off:kf_off + n_kf_s].set(
            src_t.kf_cam[:n_kf_s]),
        kf_feat_valid=dst.kf_feat_valid.at[kf_off:kf_off + n_kf_s].set(
            src_t.kf_feat_valid[:n_kf_s]),
        kf_obs=dst.kf_obs.at[kf_off:kf_off + n_kf_s].set(src_obs),
        kf_bow=dst.kf_bow.at[kf_off:kf_off + n_kf_s].set(
            src_t.kf_bow[:n_kf_s]),
        mp_pos=dst.mp_pos.at[mp_off:mp_off + n_mp_s].set(
            src_t.mp_pos[:n_mp_s]),
        mp_desc=dst.mp_desc.at[mp_off:mp_off + n_mp_s].set(
            src_t.mp_desc[:n_mp_s]),
        mp_normal=dst.mp_normal.at[mp_off:mp_off + n_mp_s].set(
            src_t.mp_normal[:n_mp_s]),
        mp_dmin=dst.mp_dmin.at[mp_off:mp_off + n_mp_s].set(
            s * src_t.mp_dmin[:n_mp_s]),
        mp_dmax=dst.mp_dmax.at[mp_off:mp_off + n_mp_s].set(
            s * src_t.mp_dmax[:n_mp_s]),
        mp_valid=dst.mp_valid.at[mp_off:mp_off + n_mp_s].set(
            src_t.mp_valid[:n_mp_s]),
        mp_first_kf=dst.mp_first_kf.at[mp_off:mp_off + n_mp_s].set(
            src_t.mp_first_kf[:n_mp_s] + kf_off),
        mp_last_kf=dst.mp_last_kf.at[mp_off:mp_off + n_mp_s].set(
            src_t.mp_last_kf[:n_mp_s] + kf_off),
        n_kf=jnp.asarray(n_kf_d + n_kf_s, jnp.int32),
        n_mp=jnp.asarray(n_mp_d + n_mp_s, jnp.int32),
    )
    # carry src's persistent loop edges across (slots shift by kf_off),
    # then record the weld itself as a permanent merge edge (reference:
    # mspMergeEdges, KeyFrame.h:216-243)
    for li, lj, lv in zip(np.asarray(src.loop_i), np.asarray(src.loop_j),
                          np.asarray(src.loop_valid)):
        if lv and li >= 0 and lj >= 0:
            out = ms.add_loop_edge(out, int(li) + kf_off,
                                   int(lj) + kf_off)
    return out, True
