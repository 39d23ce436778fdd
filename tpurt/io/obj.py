"""Wavefront OBJ loading (and writing, for test round-trips).

The replacement for the reference's model pipeline
(tiny_obj_loader parse -> vertex dedup -> interleaved vertex buffer + 32-bit
index buffer, in ``loadModel()`` of Source/RayTracedShadows.cpp [RECALL;
reference mount was empty at survey time]).

Supported subset: ``v``, ``vn``, ``vt``, ``f`` with any of the ``v``,
``v/vt``, ``v//vn``, ``v/vt/vn`` forms, negative (relative) indices, and
polygon fan-triangulation. ``usemtl``/``mtllib`` assign per-triangle
albedo: real ``Kd`` colors from the .mtl, a deterministic palette for
unresolved names — and when a material carries ``map_Kd`` pointing at a
readable PNG, the loader builds the texture atlas (Mesh.tex_atlas /
uv / tri_tex; sampled by passes/texture.py).

Vertices referenced with differing normal indices are deduplicated on the
(position, normal) pair, mirroring the reference's dedup of OBJ multi-index
corners into a single GPU vertex stream.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..scenes import compute_smooth_normals, make_mesh
from ..types import Mesh


def _material_color(name: str) -> np.ndarray:
    """Deterministic pseudo-color per material name (fallback when no
    .mtl file provides a real diffuse color)."""
    h = hashlib.sha256(name.encode()).digest()
    rgb = np.frombuffer(h[:3], dtype=np.uint8).astype(np.float32) / 255.0
    return 0.25 + 0.65 * rgb


def parse_mtl(path: str) -> Dict[str, dict]:
    """Parse a Wavefront .mtl file -> {material name: {"kd": f32[3],
    "map_kd": filename | None}}. The reference reads the same diffuse
    colors/textures through tiny_obj_loader [RECALL]; unsupported
    statements are skipped."""
    out: Dict[str, dict] = {}
    current: Optional[str] = None
    try:
        f = open(path, "r", errors="replace")
    except OSError:
        return out
    with f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "newmtl" and len(parts) > 1:
                current = parts[1]
                out.setdefault(current, {"kd": np.full(3, 0.8, np.float32),
                                         "map_kd": None})
            elif parts[0] == "Kd" and current is not None and len(parts) >= 4:
                out[current]["kd"] = np.asarray(
                    [float(parts[1]), float(parts[2]), float(parts[3])],
                    np.float32)
            elif parts[0] == "map_Kd" and current is not None \
                    and len(parts) > 1:
                out[current]["map_kd"] = parts[-1]   # options ignored
    return out


def _material_table(obj_dir: str, mtllibs: List[str]) -> Dict[str, dict]:
    table: Dict[str, dict] = {}
    import os
    for lib in mtllibs:
        table.update(parse_mtl(os.path.join(obj_dir, lib)))
    return table


def _resolve_albedo(names: List[Optional[str]], obj_dir: str,
                    mtllibs: List[str]) -> np.ndarray:
    """Per-triangle albedo: real Kd from the mtllib when available, the
    deterministic pseudo-color for unresolved names, flat 0.8 for faces
    with no material at all. Shared by both loaders so the same OBJ renders
    identically regardless of which parser ran."""
    table = _material_table(obj_dir, mtllibs)
    cache: Dict[Optional[str], np.ndarray] = {None: np.full(3, 0.8, np.float32)}
    out = np.empty((len(names), 3), np.float32)
    for i, n in enumerate(names):
        c = cache.get(n)
        if c is None:
            m = table.get(n)
            c = m["kd"] if m is not None else _material_color(n)
            cache[n] = c
        out[i] = c
    return out


ATLAS_RES = 128   # every diffuse texture is resampled onto this square


def _nearest_resample(img: np.ndarray, r: int) -> np.ndarray:
    h, w = img.shape[:2]
    ys = (np.arange(r) * h // r).clip(0, h - 1)
    xs = (np.arange(r) * w // r).clip(0, w - 1)
    out = img[ys][:, xs]
    if out.ndim == 2:
        out = np.repeat(out[..., None], 3, axis=-1)
    return out[..., :3].astype(np.float32) / (255.0 if img.dtype == np.uint8
                                              else 1.0)


def _resolve_textures(names: List[Optional[str]], obj_dir: str,
                      mtllibs: List[str]
                      ) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """Per-triangle texture layers: load each referenced map_Kd (PNG via
    io/image.py) once, nearest-resample onto the fixed-resolution atlas.
    Returns (atlas f32[NT, R, R, 3] or None, tri_tex i32[T])."""
    import os
    from .image import read_png
    table = _material_table(obj_dir, mtllibs)
    layers: Dict[str, int] = {}
    imgs: List[np.ndarray] = []
    tri_tex = np.full(len(names), -1, np.int32)
    for i, n in enumerate(names):
        if n is None:
            continue
        m = table.get(n)
        if m is None or m.get("map_kd") is None:
            continue
        fname = m["map_kd"]
        lid = layers.get(fname)
        if lid is None:
            try:
                img = read_png(os.path.join(obj_dir, fname))
            except Exception:  # noqa: BLE001 - unreadable/missing texture
                layers[fname] = -1
                continue
            lid = len(imgs)
            imgs.append(_nearest_resample(np.asarray(img), ATLAS_RES))
            layers[fname] = lid
        tri_tex[i] = lid
    if not imgs:
        return None, tri_tex
    return np.stack(imgs).astype(np.float32), tri_tex


def _mesh_from_raw(pos: np.ndarray, nrm: np.ndarray, tc: np.ndarray,
                   tri_pos: np.ndarray, tri_nrm: np.ndarray,
                   tri_tex: np.ndarray, tri_mtl: np.ndarray,
                   mtl_names: List[str], mtllibs: List[str],
                   obj_dir: str) -> Mesh:
    """Vectorized corner dedup + normal/material/texture resolution for
    the native parser's raw output (same rules as the Python loader:
    texcoords only split vertices when a texture actually resolved)."""
    names = [mtl_names[k] if 0 <= k < len(mtl_names) else None
             for k in tri_mtl.tolist()]
    atlas, tri_texlayer = _resolve_textures(names, obj_dir, mtllibs)
    use_uv = atlas is not None and len(tc) > 0
    cols = [tri_pos.reshape(-1), tri_nrm.reshape(-1)]
    if use_uv:
        cols.append(tri_tex.reshape(-1))
    corners = np.stack(cols, axis=1)
    uniq, inverse = np.unique(corners, axis=0, return_inverse=True)
    indices = inverse.reshape(-1, 3).astype(np.int32)
    vertices = pos[uniq[:, 0]].astype(np.float32)
    have_all_normals = len(nrm) > 0 and (uniq[:, 1] >= 0).all()
    if have_all_normals:
        vn = nrm[np.clip(uniq[:, 1], 0, len(nrm) - 1)].astype(np.float32)
        lens = np.linalg.norm(vn, axis=1, keepdims=True)
        vnormals = np.where(lens > 1e-12, vn / np.maximum(lens, 1e-12),
                            np.array([0, 1, 0], np.float32))
    else:
        vnormals = compute_smooth_normals(vertices, indices)
    albedo = _resolve_albedo(names, obj_dir, mtllibs)
    uv = None
    if use_uv:
        ti = uniq[:, 2]
        uv = np.where((ti >= 0)[:, None],
                      tc[np.clip(ti, 0, len(tc) - 1)],
                      np.zeros(2, np.float32)).astype(np.float32)
    return Mesh(vertices=vertices, normals=vnormals.astype(np.float32),
                indices=indices, albedo=albedo, uv=uv,
                tex_atlas=atlas if use_uv else None,
                tri_tex=tri_texlayer if use_uv else None)


def load_obj(path: str, use_native: bool | None = None) -> Mesh:
    """Load an OBJ mesh. use_native=None tries the C++ parser
    (tpurt/native.py, ~50x faster on large files; flat albedo) and falls
    back to the pure-Python parser (which also assigns per-material
    pseudo-colors)."""
    if use_native is not False:
        import os
        from .. import native
        if native.available():
            try:
                raw = native.load_obj_raw(path)
            except FileNotFoundError:
                raise
            if raw is not None:
                return _mesh_from_raw(*raw,
                                      obj_dir=os.path.dirname(
                                          os.path.abspath(path)))
        if use_native:
            raise RuntimeError("native OBJ parser requested but unavailable")
    return _load_obj_python(path)


def _load_obj_python(path: str) -> Mesh:
    positions: List[Tuple[float, float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    texcoords: List[Tuple[float, float]] = []
    faces: List[Tuple[int, ...]] = []  # (p0,n0,t0, p1,n1,t1, p2,n2,t2)
    face_mtl: List[Optional[str]] = []
    mtllibs: List[str] = []
    current_mtl: Optional[str] = None

    with open(path, "r", errors="replace") as f:
        for line in f:
            if not line or line[0] in "#\n":
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                positions.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "vn":
                normals.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "vt":
                texcoords.append((float(parts[1]),
                                  float(parts[2]) if len(parts) > 2 else 0.0))
            elif tag == "usemtl":
                current_mtl = parts[1] if len(parts) > 1 else None
            elif tag == "mtllib" and len(parts) > 1:
                mtllibs.append(" ".join(parts[1:]))
            elif tag == "f":
                corners = []
                for tok in parts[1:]:
                    fields = tok.split("/")
                    pi = int(fields[0])
                    pi = pi - 1 if pi > 0 else len(positions) + pi
                    ti = -1
                    if len(fields) >= 2 and fields[1]:
                        ti = int(fields[1])
                        ti = ti - 1 if ti > 0 else len(texcoords) + ti
                    ni = -1
                    if len(fields) >= 3 and fields[2]:
                        ni = int(fields[2])
                        ni = ni - 1 if ni > 0 else len(normals) + ni
                    corners.append((pi, ni, ti))
                # Fan triangulation (tiny_obj_loader's default triangulation).
                for k in range(1, len(corners) - 1):
                    a, b, c = corners[0], corners[k], corners[k + 1]
                    faces.append(a + b + c)
                    face_mtl.append(current_mtl)

    if not faces:
        raise ValueError(f"no faces found in OBJ file: {path}")

    pos = np.asarray(positions, np.float32)
    nrm = np.asarray(normals, np.float32) if normals else np.zeros((0, 3), np.float32)
    uvs = np.asarray(texcoords, np.float32) if texcoords \
        else np.zeros((0, 2), np.float32)

    import os
    obj_dir = os.path.dirname(os.path.abspath(path))
    # Textures resolve BEFORE dedup: texcoords only split vertices when a
    # texture actually samples them (keeps vertex streams identical to the
    # native loader for untextured scenes).
    atlas, tri_tex = _resolve_textures(face_mtl, obj_dir, mtllibs)

    # Deduplicate (position, normal, texcoord) index triples into final
    # vertices (the reference's multi-index corner dedup [RECALL]).
    corner_map: Dict[Tuple[int, int, int], int] = {}
    out_pos: List[np.ndarray] = []
    out_nrm: List[Optional[np.ndarray]] = []
    out_uv: List[np.ndarray] = []
    tri_indices = np.empty((len(faces), 3), np.int32)
    has_any_normal = len(normals) > 0
    has_any_uv = len(texcoords) > 0 and atlas is not None

    for t, f9 in enumerate(faces):
        for c in range(3):
            pi, ni, ti = f9[3 * c], f9[3 * c + 1], f9[3 * c + 2]
            key = (pi, ni if has_any_normal else -1,
                   ti if has_any_uv else -1)
            vid = corner_map.get(key)
            if vid is None:
                vid = len(out_pos)
                corner_map[key] = vid
                out_pos.append(pos[pi])
                out_nrm.append(nrm[ni] if (has_any_normal and 0 <= ni < len(nrm)) else None)
                out_uv.append(uvs[ti] if (has_any_uv and 0 <= ti < len(uvs))
                              else np.zeros(2, np.float32))
            tri_indices[t, c] = vid

    vertices = np.stack(out_pos).astype(np.float32)
    if has_any_normal and all(n is not None for n in out_nrm):
        vnormals = np.stack([n for n in out_nrm]).astype(np.float32)
        lens = np.linalg.norm(vnormals, axis=1, keepdims=True)
        vnormals = np.where(lens > 1e-12, vnormals / np.maximum(lens, 1e-12),
                            np.array([0, 1, 0], np.float32))
    else:
        vnormals = compute_smooth_normals(vertices, tri_indices)

    albedo = _resolve_albedo(face_mtl, obj_dir, mtllibs)
    uv = np.stack(out_uv).astype(np.float32) if has_any_uv else None
    return Mesh(vertices=vertices, normals=vnormals, indices=tri_indices,
                albedo=albedo, uv=uv, tex_atlas=atlas,
                tri_tex=tri_tex if atlas is not None else None)


def save_obj(path: str, mesh: Mesh) -> None:
    """Write a mesh as OBJ (v + vn + f v//vn). Used for loader round-trips."""
    v = np.asarray(mesh.vertices)
    n = np.asarray(mesh.normals)
    idx = np.asarray(mesh.indices)
    with open(path, "w") as f:
        f.write("# tpurt OBJ export\n")
        for p in v:
            f.write(f"v {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}\n")
        for p in n:
            f.write(f"vn {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}\n")
        for a, b, c in idx + 1:
            f.write(f"f {a}//{a} {b}//{b} {c}//{c}\n")
