"""Body-model assets: the synthetic stand-in.

A frozen copy of tuch_tpu_torch/assets.py's synthetic body and contact
extras (the real-asset loaders and the pose prior are left out). Everything
returns numpy arrays: the body in the SMPLModel container (models/smpl.py
turns them into module buffers), the contact extras in ContactExtras.

The synthetic body is a closed UV sphere with the exact SMPL topology at
full size (6890 vertices, 13776 faces), made with the same numpy random
stream as the JAX package, so both packages build bitwise-equal arrays from
the same seed. Its contact extras draw no random numbers.
"""

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from portbench.reference.tuchref import constants

# SMPL kinematic tree (public model topology).
SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
     18, 19, 20, 21], dtype=np.int32)


class SMPLModel(NamedTuple):
    """Static SMPL parameters as numpy arrays.

    V = #vertices, F = #faces, J = #skeleton joints (24), S = #shape
    coefficients (10), P = 9 * (J - 1) pose-corrective features (207).
    """
    v_template: np.ndarray         # (V, 3)
    shapedirs: np.ndarray          # (V, 3, S)
    posedirs: np.ndarray           # (V, 3, P)
    J_regressor: np.ndarray        # (J, V)
    lbs_weights: np.ndarray        # (V, J)
    parents: np.ndarray            # (J,) int32
    faces: np.ndarray              # (F, 3) int32
    vertex_joint_ids: np.ndarray   # (21,) int32 surface vertex ids
    J_regressor_extra: np.ndarray  # (9, V)
    joint_map: np.ndarray          # (49,) int32 into the 54-joint output


class MeanParams(NamedTuple):
    """HMR's IEF initialisation (reference buffers init_pose/shape/cam)."""
    mean_pose6d: np.ndarray  # (144,) row-interleaved 6d rotations
    mean_shape: np.ndarray   # (10,)
    mean_cam: np.ndarray     # (3,)


# ---------------------------------------------------------------------------
# Synthetic meshes
# ---------------------------------------------------------------------------

def uv_sphere(segments: int, rings: int, radius: float = 1.0
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Closed triangulated UV sphere, outward-oriented.

    V = segments * (rings - 2) + 2 vertices, F = 2 * segments * (rings - 2)
    triangles; rings counts latitude lines including both poles.
    """
    if rings < 3:
        raise ValueError(f'a UV sphere needs rings >= 3, got {rings}')
    n_lat = rings - 2  # interior latitude rings
    theta = np.pi * np.arange(1, n_lat + 1) / (n_lat + 1)
    phi = 2 * np.pi * np.arange(segments) / segments
    z = radius * np.cos(theta)[:, None]
    r = radius * np.sin(theta)[:, None]
    ring_verts = np.stack(
        [np.broadcast_to(r * np.cos(phi)[None], (n_lat, segments)),
         np.broadcast_to(r * np.sin(phi)[None], (n_lat, segments)),
         np.broadcast_to(z, (n_lat, segments))],
        axis=-1).reshape(-1, 3)
    verts = np.concatenate([
        np.array([[0.0, 0.0, radius]]), ring_verts,
        np.array([[0.0, 0.0, -radius]])], axis=0).astype(np.float32)
    south = verts.shape[0] - 1

    j = np.arange(segments)
    jn = (j + 1) % segments
    ring0 = 1 + j
    top = np.stack([np.zeros_like(j), ring0, 1 + jn], axis=-1)
    i = np.arange(n_lat - 1)[:, None]
    a = 1 + i * segments + j[None]
    b = 1 + i * segments + jn[None]
    c = 1 + (i + 1) * segments + j[None]
    d = 1 + (i + 1) * segments + jn[None]
    quads = np.concatenate(
        [np.stack([a, c, d], -1).reshape(-1, 3),
         np.stack([a, d, b], -1).reshape(-1, 3)], axis=0)
    last = 1 + (n_lat - 1) * segments
    bottom = np.stack([last + j, np.full_like(j, south), last + jn],
                      axis=-1)
    faces = np.concatenate([top, quads, bottom], axis=0)
    return verts, faces.astype(np.int32)


def _sphere_params(num_verts: int) -> Tuple[int, int]:
    """segments, rings for a UV sphere with ~num_verts vertices."""
    if num_verts >= constants.SMPL_NUM_VERTS:
        return 82, 86  # exactly 6890 verts / 13776 faces
    segs = max(8, int(np.sqrt(num_verts)))
    n_lat = max(3, (num_verts - 2) // segs)
    return segs, n_lat + 2


def synthetic_smpl(num_verts: int = constants.SMPL_NUM_VERTS, seed: int = 0
                   ) -> Tuple[SMPLModel, MeanParams]:
    """Deterministic synthetic SMPL-schema body model on a closed sphere.

    Draws the same numpy random stream, in the same order, as
    tuch_tpu.assets.synthetic_smpl, so the arrays are bitwise equal. The
    contact extras and the HD surface of the JAX version are built by
    synthetic_contact.
    """
    rng = np.random.RandomState(seed)
    segs, rings = _sphere_params(num_verts)
    sphere, faces = uv_sphere(segs, rings)
    V = sphere.shape[0]
    J = constants.SMPL_NUM_JOINTS
    S = constants.SMPL_NUM_BETAS

    # Squash the sphere into an ellipsoid and rotate the poles onto +y
    # (SMPL's up axis) with a proper rotation (x, z, -y).
    ell = sphere * np.array([0.35, 0.18, 0.9], dtype=np.float32)
    v_template = np.stack([ell[:, 0], ell[:, 2], -ell[:, 1]],
                          axis=-1).astype(np.float32)

    # 24 joints along/around the vertical (y) axis, inside the body.
    ys = np.linspace(-0.75, 0.75, J)
    joint_pos = np.stack([0.08 * np.sin(np.arange(J)), ys,
                          0.04 * np.cos(np.arange(J))], axis=-1)
    joint_pos = joint_pos.astype(np.float32)

    # J_regressor: softmax of negative distance to each joint (rows sum to 1).
    d = np.linalg.norm(v_template[None, :, :] - joint_pos[:, None, :], axis=-1)
    J_regressor = np.exp(-d ** 2 / 0.01)
    J_regressor /= J_regressor.sum(axis=1, keepdims=True)

    # Skinning weights: smooth softmax over joints.
    w = np.exp(-d.T ** 2 / 0.05)  # (V, J)
    lbs_weights = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)

    # Low-frequency shape directions: random linear fields plus an offset.
    A1 = rng.randn(S, 3, 3).astype(np.float32) * 0.02
    shapedirs = np.einsum('sde,ve->vds', A1, v_template)
    shapedirs += rng.randn(1, 3, S).astype(np.float32) * 0.002

    P = 9 * (J - 1)
    posedirs = (rng.randn(V, 3, P).astype(np.float32) * 1e-3)

    vj = np.array([constants.VERTEX_JOINT_IDS[n] % V
                   for n in constants.VERTEX_JOINT_ORDER], dtype=np.int32)

    Jx = np.zeros((9, V), dtype=np.float32)
    for r in range(9):
        cols = rng.choice(V, size=8, replace=False)
        Jx[r, cols] = 1.0 / 8

    model = SMPLModel(
        v_template=v_template,
        shapedirs=shapedirs.astype(np.float32),
        posedirs=posedirs,
        J_regressor=J_regressor.astype(np.float32),
        lbs_weights=lbs_weights,
        parents=SMPL_PARENTS,
        faces=faces,
        vertex_joint_ids=vj,
        J_regressor_extra=Jx,
        joint_map=constants.JOINT_MAP_49.copy(),
    )
    # Identity 6d rotations (row-interleaved [r11, r12, r21, r22, r31, r32]),
    # zero shape, a typical camera.
    means = MeanParams(
        mean_pose6d=np.tile(np.array([1, 0, 0, 1, 0, 0], dtype=np.float32),
                            (J,)),
        mean_shape=np.zeros(S, dtype=np.float32),
        mean_cam=np.array([0.9, 0.0, 0.0], dtype=np.float32))
    return model, means


class ContactExtras(NamedTuple):
    """What the self-contact terms need beyond the body model, and the
    dense (HD) surface of the training step's contact loss in compact
    barycentric form: HD point h is sum_j hd_bary[h, j] *
    verts[hd_vert_ids[h, j]], sampled from face hd_geovec[h]."""
    geodists: Optional[np.ndarray]  # (V, V) float32 geodesic distances
    segments: Dict[str, dict]       # name -> {'vidx', 'bands_verts'}
    contact_classes: List[tuple]    # (region_a, region_b) name pairs
    contact_csig: Dict[str, np.ndarray]  # region name -> vertex ids
    hd_vert_ids: Optional[np.ndarray] = None   # (H, k) int32
    hd_bary: Optional[np.ndarray] = None       # (H, k) float32
    hd_geovec: Optional[np.ndarray] = None     # (H,) int32 face ids


def synthetic_contact(num_verts: int = constants.SMPL_NUM_VERTS,
                      with_geodists: bool = True) -> ContactExtras:
    """The contact extras of the synthetic body, as the JAX package's
    synthetic_smpl builds them (bitwise equal; no random numbers drawn).

    geodists is the great-circle distance on the template sphere, a (V, V)
    float32 matrix (~190 MB at full size): with_geodists=False skips it.
    Segments are 9 narrow latitude bands closed by their boundary rings;
    contact regions are 8 longitude sectors, paired into 12 classes. The HD
    surface is one point per face, its barycentre (H = F).
    """
    segs, rings = _sphere_params(num_verts)
    sphere, faces = uv_sphere(segs, rings)

    geodists = None
    if with_geodists:
        unit = (sphere / np.linalg.norm(sphere, axis=-1, keepdims=True)
                ).astype(np.float32)
        cos = unit @ unit.T
        np.clip(cos, -1.0, 1.0, out=cos)
        geodists = np.arccos(cos, out=cos)

    n_lat = rings - 2

    def ring_ids(i):
        return np.arange(1 + i * segs, 1 + (i + 1) * segs)

    n_seg = min(9, max(1, n_lat // 4))
    spacing = n_lat // n_seg
    width = max(1, min(3, spacing - 2))
    segments = {}
    for si in range(n_seg):
        lo = si * spacing + (spacing - width) // 2
        hi = lo + width
        lo, hi = max(lo, 1), min(hi, n_lat - 1)  # keep boundary rings valid
        vidx = np.concatenate([ring_ids(i) for i in range(lo, hi)])
        bands = [ring_ids(lo - 1).tolist(), ring_ids(hi).tolist()]
        segments[f'patch{si}'] = {'vidx': vidx.astype(np.int64),
                                  'bands_verts': bands}

    n_regions = 8
    phi = np.arctan2(sphere[:, 1], sphere[:, 0])
    sector = ((phi + np.pi) / (2 * np.pi) * n_regions).astype(int) % n_regions
    csig = {f'reg{r}': np.where(sector == r)[0].astype(np.int64)
            for r in range(n_regions)}
    classes = [(f'reg{a}', f'reg{b}')
               for a in range(n_regions) for b in range(a + 1, n_regions)][:12]
    F = faces.shape[0]
    return ContactExtras(geodists=geodists, segments=segments,
                         contact_classes=classes, contact_csig=csig,
                         hd_vert_ids=faces.astype(np.int32),
                         hd_bary=np.full((F, 3), 1.0 / 3, np.float32),
                         hd_geovec=np.arange(F, dtype=np.int32))
