"""Atlas / map checkpointing.

JAX replacement for the reference's boost-serialization Atlas
save/load (reference: System::SaveAtlas/LoadAtlas src/System.cc:1420-1556
with MD5 vocabulary checksum; per-class serialize + PreSave/PostLoad fixup).
Because the map is already a structure of arrays, a checkpoint is one
compressed npz plus a JSON header with a config hash — no pointer fixup.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import jax
import jax.numpy as jnp

from ..slam_map import map_state as ms

FORMAT_VERSION = 1


def _from_fields(get, stored_fields) -> ms.MapState:
    """MapState from stored arrays, default-filling fields added after
    the checkpoint was written (forward compatibility)."""
    vals = {}
    for f in ms.MapState._fields:
        if f in stored_fields:
            vals[f] = jnp.asarray(get(f))
    missing = [f for f in ms.MapState._fields if f not in vals]
    if missing:
        L = ms.MAX_LOOP_EDGES
        defaults = {
            "loop_i": jnp.full((L,), -1, jnp.int32),
            "loop_j": jnp.full((L,), -1, jnp.int32),
            "loop_valid": jnp.zeros((L,), bool),
            "n_loop": jnp.zeros((), jnp.int32),
        }
        for f in missing:
            if f == "kf_bow":
                # signatures are a pure function of stored descriptors —
                # rebuild rather than defaulting to zeros (a zero
                # signature would silently disable retrieval)
                from ..slam_map import bow
                vals[f] = jax.vmap(bow.histogram)(
                    vals["kf_desc"], vals["kf_feat_valid"])
                continue
            if f not in defaults:
                raise ValueError(f"checkpoint missing field {f!r} with "
                                 "no known default")
            vals[f] = defaults[f]
    return ms.MapState(**vals)


def config_hash(cfg_dict: dict) -> str:
    """Stable hash binding a checkpoint to its configuration (the analog of
    the reference's vocabulary MD5 binding, System.cc:1520-1556)."""
    blob = json.dumps(cfg_dict, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def save_map(path: str, m: ms.MapState, cfg_dict: dict | None = None):
    arrays = {f: np.asarray(getattr(m, f)) for f in m._fields}
    header = json.dumps({
        "format": FORMAT_VERSION,
        "config_hash": config_hash(cfg_dict or {}),
        "fields": list(m._fields),
    })
    np.savez_compressed(path, __header__=np.frombuffer(
        header.encode(), dtype=np.uint8), **arrays)


def load_map(path: str, cfg_dict: dict | None = None,
             strict: bool = True) -> ms.MapState:
    with np.load(path) as data:
        header = json.loads(bytes(data["__header__"]).decode())
        if header["format"] != FORMAT_VERSION:
            raise ValueError(f"checkpoint format {header['format']} != "
                             f"{FORMAT_VERSION}")
        if strict and cfg_dict is not None:
            h = config_hash(cfg_dict)
            if h != header["config_hash"]:
                raise ValueError(
                    "checkpoint was written with a different configuration "
                    f"({header['config_hash']} != {h})")
        return _from_fields(lambda f: data[f], header["fields"])


def save_atlas(path: str, atlas, cfg_dict: dict | None = None):
    """Whole-Atlas checkpoint: every map + the current-map index
    (reference: System::SaveAtlas serializes the full Atlas,
    src/System.cc:1420-1458). One npz; map i's field f is stored as
    `m{i}__{f}`."""
    arrays = {}
    for i, m in enumerate(atlas.maps):
        for f in m._fields:
            arrays[f"m{i}__{f}"] = np.asarray(getattr(m, f))
    header = json.dumps({
        "format": FORMAT_VERSION,
        "config_hash": config_hash(cfg_dict or {}),
        "kind": "atlas",
        "n_maps": len(atlas.maps),
        "current": atlas.current,
        "fields": list(atlas.maps[0]._fields) if atlas.maps else [],
    })
    np.savez_compressed(path, __header__=np.frombuffer(
        header.encode(), dtype=np.uint8), **arrays)


def load_atlas(path: str, cfg_dict: dict | None = None,
               strict: bool = True):
    """Load a whole-Atlas checkpoint; returns (maps list, current idx)."""
    with np.load(path) as data:
        header = json.loads(bytes(data["__header__"]).decode())
        if header["format"] != FORMAT_VERSION:
            raise ValueError(f"checkpoint format {header['format']} != "
                             f"{FORMAT_VERSION}")
        if strict and cfg_dict is not None:
            h = config_hash(cfg_dict)
            if h != header["config_hash"]:
                raise ValueError(
                    "checkpoint was written with a different "
                    f"configuration ({header['config_hash']} != {h})")
        if header.get("kind") != "atlas":
            # single-map checkpoint: wrap as a 1-map atlas
            return [_from_fields(lambda f: data[f], header["fields"])], 0
        maps = []
        for i in range(header["n_maps"]):
            maps.append(_from_fields(
                lambda f, i=i: data[f"m{i}__{f}"], header["fields"]))
        return maps, header["current"]
