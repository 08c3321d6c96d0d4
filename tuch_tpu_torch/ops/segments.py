"""Body segments: forgiving allowed self-intersections.

Counterpart of tuch_tpu/ops/segments.py. Each body segment (crook of elbow
or knee, armpit, ...) is a sub-mesh closed by fans over its boundary rings.
A vertex that the global winding test calls interior is forgiven when it
is interior only within its own segment.

The tables are built in numpy (a copy of the JAX package's
build_segment_tables); `to_device` moves the fused arrays onto a device.
The fused test runs every segment of every body in ONE winding launch,
with the B * S sub-problems as the kernel's batch rows.
"""

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from tuch_tpu_torch.ops.contact_kernels import winding_numbers_tris


class SegmentTables(NamedTuple):
    """Per-segment data padded to fixed shapes.

    The fused_* arrays pack all S segments into one rectangular problem:
    vertex ids padded to Ns_max, faces padded to Fs_max and remapped into
    one extended vertex list [body verts | all band centroids | one far
    vertex]; padding faces point at the far vertex (zero solid angle),
    padding points are masked out. After to_device the fused arrays and the
    ring tables are tensors; the per-segment tuples stay numpy.
    """
    names: tuple
    vidx: tuple                  # per segment: (Ns,) vertex ids
    band_verts: tuple            # per segment: list of ring vertex ids
    faces: tuple                 # per segment: (Fs, 3) into [V + centroids]
    fused_vidx: object           # (S, Ns_max) int (pad: 0)
    fused_vmask: object          # (S, Ns_max) bool
    fused_faces: object          # (S, Fs_max, 3) int into extended verts
    ring_idx: object             # (C, L_max) int band-ring vertex ids
    ring_w: object               # (C, L_max) f32 mean weights (0 on pad)
    num_verts: int


def build_segment_tables(segments: Dict[str, dict], faces: np.ndarray,
                         num_verts: int) -> SegmentTables:
    """Closed sub-meshes of each segment (numpy).

    segments: name -> {'vidx': (Ns,) vertex ids, 'bands_verts': [rings]};
    faces: (F, 3) body faces. Faces wholly inside a segment are kept and
    each boundary ring is closed by a fan to an appended centroid vertex.
    """
    names, vidxs, bands, segfaces = [], [], [], []
    for name, seg in segments.items():
        vidx = np.asarray(seg['vidx'], dtype=np.int64)
        inseg = np.zeros(num_verts, dtype=bool)
        inseg[vidx] = True
        f_seg = faces[inseg[faces].all(axis=1)].astype(np.int64)
        band_faces = []
        for bi, ring in enumerate(seg['bands_verts']):
            ring = np.asarray(ring, dtype=np.int64)
            new_vert = num_verts + bi  # appended centroid index
            for i in range(len(ring) - 1):
                band_faces.append([ring[i + 1], ring[i], new_vert])
            band_faces.append([ring[0], ring[-1], new_vert])
        all_faces = np.concatenate(
            [f_seg, np.asarray(band_faces, dtype=np.int64).reshape(-1, 3)],
            axis=0) if band_faces else f_seg
        names.append(name)
        vidxs.append(vidx)
        bands.append([np.asarray(r, dtype=np.int64)
                      for r in seg['bands_verts']])
        segfaces.append(all_faces)

    S = len(names)
    rings_flat = [r for seg_bands in bands for r in seg_bands]
    C = len(rings_flat)
    L_max = max((len(r) for r in rings_flat), default=1)
    ring_idx = np.zeros((C, L_max), np.int32)
    ring_w = np.zeros((C, L_max), np.float32)
    for ci, r in enumerate(rings_flat):
        ring_idx[ci, :len(r)] = r
        ring_w[ci, :len(r)] = 1.0 / len(r)

    far_idx = num_verts + C
    Ns_max = max((len(v) for v in vidxs), default=1)
    Fs_max = max((f.shape[0] for f in segfaces), default=1)
    fused_vidx = np.zeros((S, Ns_max), np.int32)
    fused_vmask = np.zeros((S, Ns_max), bool)
    fused_faces = np.full((S, Fs_max, 3), far_idx, np.int32)
    ring_off = 0
    for si in range(S):
        v = vidxs[si]
        fused_vidx[si, :len(v)] = v
        fused_vmask[si, :len(v)] = True
        f = segfaces[si].copy()
        # per-segment centroid ids (num_verts + bi) -> global centroid rows
        f[f >= num_verts] += ring_off
        fused_faces[si, :f.shape[0]] = f
        ring_off += len(bands[si])

    return SegmentTables(names=tuple(names), vidx=tuple(vidxs),
                         band_verts=tuple(bands), faces=tuple(segfaces),
                         fused_vidx=fused_vidx, fused_vmask=fused_vmask,
                         fused_faces=fused_faces, ring_idx=ring_idx,
                         ring_w=ring_w, num_verts=num_verts)


def to_device(tables: SegmentTables, device) -> SegmentTables:
    """The fused arrays and ring tables (numpy or tensors) as tensors on
    `device`: indices int64, the mask bool, the weights float32."""
    def put(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=device)
    return tables._replace(
        fused_vidx=put(tables.fused_vidx, torch.long),
        fused_vmask=put(tables.fused_vmask, torch.bool),
        fused_faces=put(tables.fused_faces, torch.long),
        ring_idx=put(tables.ring_idx, torch.long),
        ring_w=put(tables.ring_w, torch.float32))


def segment_exterior_per_segment(tables: SegmentTables,
                                 vertices: torch.Tensor
                                 ) -> List[torch.Tensor]:
    """One winding test per segment, for its own vertices: a list of
    (B, Ns) bool, True where the vertex is exterior of its closed segment
    mesh. The fused test is the one the loss runs; this one checks it."""
    out = []
    for vidx, bands, faces in zip(tables.vidx, tables.band_verts,
                                  tables.faces):
        extra = [vertices[:, torch.as_tensor(ring, device=vertices.device)]
                 .mean(dim=1, keepdim=True) for ring in bands]
        verts_ext = torch.cat([vertices] + extra, dim=1)
        pts = vertices[:, torch.as_tensor(vidx, device=vertices.device)]
        tris = verts_ext[:, torch.as_tensor(faces, device=vertices.device)]
        out.append(winding_numbers_tris(pts, tris) <= 0.99)
    return out


def fused_problem(tables: SegmentTables, vertices: torch.Tensor):
    """The fused winding problem of all segments: points (B * S, Ns_max, 3)
    and triangles (B * S, Fs_max, 3, 3), over the extended vertex list
    [body | band-ring centroids | one far vertex at 1e7]."""
    dev = vertices.device
    B = vertices.shape[0]
    fv = torch.as_tensor(tables.fused_vidx, device=dev).long()
    ff = torch.as_tensor(tables.fused_faces, device=dev).long()
    ring_idx = torch.as_tensor(tables.ring_idx, device=dev).long()
    ring_w = torch.as_tensor(tables.ring_w, device=dev)
    S, Ns = fv.shape
    cent = torch.einsum('cl,bcld->bcd', ring_w, vertices[:, ring_idx])
    far = vertices.new_full((B, 1, 3), 1e7)
    verts_ext = torch.cat([vertices, cent, far], dim=1)
    pts = vertices[:, fv.reshape(-1)].reshape(B * S, Ns, 3)
    tris = verts_ext[:, ff.reshape(-1)].reshape(B * S, ff.shape[1], 3, 3)
    return pts, tris


def segment_exterior_fused(tables: SegmentTables, vertices: torch.Tensor
                           ) -> torch.Tensor:
    """All segments' exterior tests in ONE winding evaluation.

    vertices (B, V, 3) -> (B, S, Ns_max) bool; padded slots are True
    (exterior: nothing to forgive).
    """
    vmask = torch.as_tensor(tables.fused_vmask, device=vertices.device)
    wn = winding_numbers_tris(*fused_problem(tables, vertices))
    return (wn <= 0.99).reshape(vertices.shape[0], *vmask.shape) \
        | ~vmask[None]


def forgive_segment_interiors(tables: SegmentTables, vertices: torch.Tensor,
                              exterior: torch.Tensor) -> torch.Tensor:
    """exterior (B, V) bool from the global test, with every vertex that
    is interior of its own segment set exterior (an allowed
    self-intersection): exterior[v] |= ~segment_exterior[v].

    One scatter-max over the fused layout. Its padded slots point at vertex
    0 with a 0 update, so a plain assignment could overwrite a 1 there;
    the max cannot.
    """
    seg_ext = segment_exterior_fused(tables, vertices)       # (B, S, Ns)
    dev = vertices.device
    B = vertices.shape[0]
    vmask = torch.as_tensor(tables.fused_vmask, device=dev)
    upd = (~seg_ext & vmask[None]).reshape(B, -1).int()
    idx = torch.as_tensor(tables.fused_vidx, device=dev).long().reshape(-1)
    forgiven = torch.zeros(exterior.shape, dtype=torch.int32, device=dev)
    forgiven.scatter_reduce_(1, idx[None].expand(B, -1), upd, 'amax')
    return exterior | (forgiven > 0)
