"""Offline software mesh renderer: agent + reference-ghost overlay videos.

Counterpart of ``add_gym_tpu/render/mesh.py`` (the port's own copy; it
imports nothing of the JAX package).  Rendering runs on the host from
dumped body poses:

- binary-STL load + area-ranked decimation (numpy),
- MJCF visual-geom parse (the group-1 mesh geoms: mesh name, offset,
  per-body color),
- a perspective painter's-algorithm rasterizer (PIL) with Lambert shading
  and a ground grid; the ghost renders from the same triangle pool so
  agent/ghost mutual occlusion is depth-correct.

PIL and imageio are imported inside the functions that use them.  All
arrays numpy; wxyz quaternions throughout.
"""

from __future__ import annotations

import os
import struct
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


# ------------------------------------------------------------------ STL load


def load_stl(path: str) -> np.ndarray:
    """Binary STL -> triangle vertices [T, 3, 3] (float32)."""
    with open(path, "rb") as f:
        data = f.read()
    n = struct.unpack("<I", data[80:84])[0]
    if len(data) < 84 + n * 50:
        raise ValueError(f"{path}: not a binary STL")
    raw = np.frombuffer(data, dtype=np.uint8, count=n * 50, offset=84)
    rec = raw.reshape(n, 50)
    floats = rec[:, :48].copy().view("<f4").reshape(n, 4, 3)
    return floats[:, 1:4].astype(np.float32)         # drop the normal row


def decimate(tris: np.ndarray, max_tris: int) -> np.ndarray:
    """Keep the ``max_tris`` largest-area triangles (most visible surface)."""
    if len(tris) <= max_tris:
        return tris
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    area = np.linalg.norm(np.cross(e1, e2), axis=1)
    keep = np.argpartition(-area, max_tris)[:max_tris]
    return tris[keep]


# -------------------------------------------------------------- MJCF visuals


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


@dataclass
class BodyMesh:
    body_index: int
    verts: np.ndarray   # [T, 3, 3] body-frame triangle vertices
    color: np.ndarray   # [3] 0-1


class RobotMeshModel:
    """Visual meshes per body, parsed from the robot MJCF.

    ``body_names`` fixes the body index order (BFS client order from
    CharModel/PhysicsModel so FK outputs index directly).
    """

    def __init__(self, mjcf_path: str, body_names: List[str],
                 max_tris_per_mesh: int = 550):
        tree = ET.parse(mjcf_path)
        root = tree.getroot()
        comp = root.find("compiler")
        meshdir = os.path.join(
            os.path.dirname(os.path.abspath(mjcf_path)),
            comp.attrib.get("meshdir", ".") if comp is not None else ".",
        )
        mesh_files = {}
        asset = root.find("asset")
        if asset is not None:
            for m in asset.findall("mesh"):
                mesh_files[m.attrib["name"]] = m.attrib["file"]

        index = {n: i for i, n in enumerate(body_names)}
        cache: dict = {}
        self.meshes: List[BodyMesh] = []

        def visit(body_el):
            name = body_el.attrib.get("name")
            bi = index.get(name)
            if bi is not None:
                for g in body_el.findall("geom"):
                    if g.attrib.get("type") != "mesh":
                        continue
                    # render only the group-1 visual geoms (the G1 MJCF
                    # repeats some meshes as ungrouped collision geoms)
                    if g.attrib.get("group") != "1":
                        continue
                    mesh_name = g.attrib.get("mesh")
                    if mesh_name not in mesh_files:
                        continue
                    if mesh_name not in cache:
                        path = os.path.join(meshdir, mesh_files[mesh_name])
                        try:
                            cache[mesh_name] = decimate(
                                load_stl(path), max_tris_per_mesh
                            )
                        except (OSError, ValueError):
                            cache[mesh_name] = None
                    tris = cache[mesh_name]
                    if tris is None:
                        continue
                    pos = np.array(
                        g.attrib.get("pos", "0 0 0").split(), dtype=np.float32
                    )
                    quat = np.array(
                        g.attrib.get("quat", "1 0 0 0").split(),
                        dtype=np.float32,
                    )
                    rgba = np.array(
                        g.attrib.get("rgba", "0.55 0.55 0.6 1").split(),
                        dtype=np.float32,
                    )
                    R = _quat_to_mat(quat)
                    v = tris @ R.T + pos
                    self.meshes.append(BodyMesh(bi, v.astype(np.float32),
                                                rgba[:3]))
            for child in body_el.findall("body"):
                visit(child)

        wb = root.find("worldbody")
        for b in wb.findall("body"):
            visit(b)
        if not self.meshes:
            raise ValueError(f"no visual meshes found in {mjcf_path}")

    def triangle_count(self) -> int:
        return sum(len(m.verts) for m in self.meshes)


# --------------------------------------------------------------- rasterizer


def _quats_to_mats(q: np.ndarray) -> np.ndarray:
    """wxyz [..., 4] -> [..., 3, 3]."""
    w, x, y, z = (q[..., i] for i in range(4))
    n = w * w + x * x + y * y + z * z
    s = 2.0 / np.maximum(n, 1e-12)
    M = np.empty(q.shape[:-1] + (3, 3), q.dtype)
    M[..., 0, 0] = 1 - s * (y * y + z * z)
    M[..., 0, 1] = s * (x * y - z * w)
    M[..., 0, 2] = s * (x * z + y * w)
    M[..., 1, 0] = s * (x * y + z * w)
    M[..., 1, 1] = 1 - s * (x * x + z * z)
    M[..., 1, 2] = s * (y * z - x * w)
    M[..., 2, 0] = s * (x * z - y * w)
    M[..., 2, 1] = s * (y * z + x * w)
    M[..., 2, 2] = 1 - s * (x * x + y * y)
    return M


def _world_triangles(model: RobotMeshModel, body_pos, body_rot_mats,
                     color_override=None, alpha=1.0):
    """Transform all body meshes to world space for one frame.

    Returns (tris [T, 3, 3], colors [T, 3], alphas [T]).
    """
    vs, cs = [], []
    for m in model.meshes:
        R = body_rot_mats[m.body_index]
        p = body_pos[m.body_index]
        v = m.verts @ R.T + p
        vs.append(v)
        c = color_override if color_override is not None else m.color
        cs.append(np.broadcast_to(np.asarray(c, np.float32), (len(v), 3)))
    tris = np.concatenate(vs)
    cols = np.concatenate(cs)
    return tris, cols, np.full(len(tris), alpha, np.float32)


def render_frames(
    model: RobotMeshModel,
    body_pos: np.ndarray,             # [F, nb, 3]
    body_rot: np.ndarray,             # [F, nb, 4] wxyz
    ghost_body_pos: Optional[np.ndarray] = None,
    ghost_body_rot: Optional[np.ndarray] = None,
    size=(640, 480),
    cam_distance: float = 3.2,
    cam_azimuth_deg: float = 40.0,
    cam_elevation_deg: float = 18.0,
    ghost_color=(0.35, 0.8, 0.45),
    ghost_alpha: float = 0.45,
):
    """Render frames of the agent (and optional reference ghost) -> PIL list.

    The camera tracks the agent's root.  The ghost (reference motion) draws
    translucently from the same depth-sorted triangle pool.
    """
    from PIL import Image, ImageDraw

    F = body_pos.shape[0]
    W, H = size
    az = np.deg2rad(cam_azimuth_deg)
    el = np.deg2rad(cam_elevation_deg)
    fwd = -np.array([
        np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)
    ])
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    fl = 1.2 * W                                     # focal length px

    rot_mats = _quats_to_mats(np.asarray(body_rot))
    ghost_mats = (
        _quats_to_mats(np.asarray(ghost_body_rot))
        if ghost_body_rot is not None else None
    )
    light = np.array([0.35, 0.25, 0.9])
    light /= np.linalg.norm(light)

    frames = []
    for f in range(F):
        tris, cols, alphas = _world_triangles(model, body_pos[f], rot_mats[f])
        if ghost_body_pos is not None:
            gt, gc, ga = _world_triangles(
                model, ghost_body_pos[f], ghost_mats[f],
                color_override=ghost_color, alpha=ghost_alpha,
            )
            tris = np.concatenate([tris, gt])
            cols = np.concatenate([cols, gc])
            alphas = np.concatenate([alphas, ga])

        target = body_pos[f, 0] * np.array([1.0, 1.0, 0.0]) + [0, 0, 0.65]
        eye = target - cam_distance * fwd

        img = Image.new("RGB", size, (245, 246, 248))
        draw = ImageDraw.Draw(img, "RGBA")

        def project(pts):
            rel = pts - eye
            x = rel @ right
            y = rel @ up
            z = rel @ fwd
            z = np.maximum(z, 1e-3)
            return (
                W / 2 + fl * x / z,
                H / 2 - fl * y / z,
                z,
            )

        # ground grid around the agent
        gx0, gy0 = np.floor(target[0]) - 3, np.floor(target[1]) - 3
        for i in range(8):
            for a, b in (
                ([gx0 + i, gy0, 0.0], [gx0 + i, gy0 + 7, 0.0]),
                ([gx0, gy0 + i, 0.0], [gx0 + 7, gy0 + i, 0.0]),
            ):
                (xa, ya, za) = project(np.asarray([a], np.float64))
                (xb, yb, zb) = project(np.asarray([b], np.float64))
                if za[0] > 0.05 and zb[0] > 0.05:
                    draw.line(
                        [(xa[0], ya[0]), (xb[0], yb[0])],
                        fill=(205, 208, 214), width=1,
                    )

        px, py, pz = project(tris.reshape(-1, 3))
        px = px.reshape(-1, 3)
        py = py.reshape(-1, 3)
        depth = pz.reshape(-1, 3).mean(1)
        # drop sub-pixel triangles: halves the draw count with no visible
        # change (decimation already keeps the largest faces)
        sarea = np.abs(
            (px[:, 1] - px[:, 0]) * (py[:, 2] - py[:, 0])
            - (px[:, 2] - px[:, 0]) * (py[:, 1] - py[:, 0])
        )
        visible = sarea > 0.6

        # Lambert shade from world-space normals
        e1 = tris[:, 1] - tris[:, 0]
        e2 = tris[:, 2] - tris[:, 0]
        nrm = np.cross(e1, e2)
        ln = np.linalg.norm(nrm, axis=1, keepdims=True)
        nrm = nrm / np.maximum(ln, 1e-12)
        shade = 0.45 + 0.55 * np.abs(nrm @ light)
        rgb = np.clip(cols * shade[:, None] * 255.0, 0, 255).astype(np.uint8)
        a8 = (alphas * 255).astype(np.uint8)

        order = np.argsort(-depth)                  # far -> near
        order = order[visible[order]]
        for t in order:
            draw.polygon(
                [(px[t, 0], py[t, 0]), (px[t, 1], py[t, 1]),
                 (px[t, 2], py[t, 2])],
                fill=(int(rgb[t, 0]), int(rgb[t, 1]), int(rgb[t, 2]),
                      int(a8[t])),
            )
        frames.append(img)
    return frames


def save_video(frames, out_file: str, fps: float = 30.0):
    """Write PIL frames to .mp4 (imageio/ffmpeg) or .gif (PIL fallback)."""
    import numpy as _np

    if out_file.endswith(".gif"):
        frames[0].save(
            out_file, save_all=True, append_images=frames[1:],
            duration=int(1000 / fps), loop=0,
        )
        return
    import imageio.v2 as imageio

    with imageio.get_writer(out_file, fps=fps) as w:
        for fr in frames:
            w.append_data(_np.asarray(fr))
