"""Write a dense float grid as a NanoVDB (.nvdb) file in the layout that
``read_nvdb_dense`` (both packages) parses: NanoVDB 32.3, one float grid, no
compression, optionally gzip-wrapped or as a bare GridData blob.

    write_nvdb(path, dense, index_min=(0, 0, 0), gzip_wrap=False, file_header=True)

The tree is the one NanoVDB builds: a root whose tiles point at upper
internal nodes (32^3 children, 4096 voxels a side), lower internal nodes
(16^3, 128 voxels) and leaves of 8^3 values, each child at its NanoVDB
index in its parent's table, every offset relative to the parent. A leaf
block is written for every 8^3 block the grid touches, the voxels outside the
grid holding the background 0 (the readers drop a leaf that straddles the
index box). Only the fields the readers use carry meaning; the rest of
GridData and FileMetaData is zero. A test helper: the package has no writer.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

MAGIC = 0x304244566F6E614E  # "NanoVDB0": a file
MAGIC_GRID = 0x314244566F6E614E  # "NanoVDB1": a bare grid
VERSION = (32 << 21) | (3 << 10) | 3
GRID_DATA_SIZE = 672
TREE_DATA_SIZE = 64
ROOT_DATA_SIZE = 64
TILE_SIZE = 32
LEAF_SIZE = 16 + 64 + 16 + 512 * 4


def _internal_sizes(log2dim: int) -> tuple[int, int]:
    """(table offset, node size) of an internal node: bbox (24), flags (8),
    value and child masks, stats (16), then the table, 32-byte aligned."""
    n = 1 << (3 * log2dim)
    table = (24 + 8 + 2 * (n // 8) + 16 + 31) & ~31
    return table, table + 8 * n


def _internal_node(log2dim: int, children: dict[int, int]) -> bytes:
    """An internal node whose child ``index`` lies ``offset`` bytes past it."""
    n = 1 << (3 * log2dim)
    table_off, size = _internal_sizes(log2dim)
    buf = bytearray(size)
    mask = np.zeros(n // 64, np.uint64)
    table = np.zeros(n, np.int64)
    for index, offset in children.items():
        mask[index >> 6] |= np.uint64(1) << np.uint64(index & 63)
        table[index] = offset
    child_mask_off = 24 + 8 + n // 8
    buf[child_mask_off:child_mask_off + n // 8] = mask.tobytes()
    buf[table_off:] = table.tobytes()
    return bytes(buf)


def nvdb_bytes(dense: np.ndarray, index_min=(0, 0, 0), file_header: bool = True) -> bytes:
    """The .nvdb bytes of a dense (X, Y, Z) f32 grid at ``index_min``."""
    dense = np.asarray(dense, np.float32)
    imin = np.asarray(index_min, np.int64)
    shape = np.asarray(dense.shape, np.int64)
    imax = imin + shape - 1
    lo, hi = imin & ~7, imax & ~7
    leaves = {}  # origin → 8^3 values
    for x in range(lo[0], hi[0] + 1, 8):
        for y in range(lo[1], hi[1] + 1, 8):
            for z in range(lo[2], hi[2] + 1, 8):
                block = np.zeros((8, 8, 8), np.float32)
                o = np.array([x, y, z])
                a, b = np.maximum(o, imin), np.minimum(o + 8, imax + 1)
                block[tuple(slice(s, e) for s, e in zip(a - o, b - o))] = dense[
                    tuple(slice(s, e) for s, e in zip(a - imin, b - imin))]
                leaves[(x, y, z)] = block

    # group leaves under lower (128 voxels) and upper (4096) origins
    tree: dict = {}
    for origin in leaves:
        up = tuple(c & ~4095 for c in origin)
        low = tuple(c & ~127 for c in origin)
        tree.setdefault(up, {}).setdefault(low, []).append(origin)

    upper_table, upper_size = _internal_sizes(5)
    lower_table, lower_size = _internal_sizes(4)
    root_size = ROOT_DATA_SIZE + TILE_SIZE * len(tree)
    nodes = bytearray()  # the upper nodes, each followed by its lower nodes and leaves
    tiles = []
    for up, lowers in sorted(tree.items()):
        upper_rel = root_size + len(nodes)  # from the root
        upper_children, body = {}, bytearray()
        for low, origins in sorted(lowers.items()):
            lower_rel = upper_size + len(body)  # from the upper node
            iu = (((low[0] & 4095) >> 7) << 10) | (((low[1] & 4095) >> 7) << 5) | (
                (low[2] & 4095) >> 7)
            upper_children[iu] = lower_rel
            lower_children, leaf_bytes = {}, bytearray()
            for origin in sorted(origins):
                il = (((origin[0] & 127) >> 3) << 8) | (((origin[1] & 127) >> 3) << 4) | (
                    (origin[2] & 127) >> 3)
                lower_children[il] = lower_size + len(leaf_bytes)
                leaf = bytearray(LEAF_SIZE)
                struct.pack_into("<3i3B", leaf, 0, *origin, 7, 7, 7)
                leaf[16:80] = b"\xff" * 64  # every voxel active
                leaf[96:] = leaves[origin].tobytes()
                leaf_bytes += leaf
            body += _internal_node(4, lower_children) + leaf_bytes
        nodes += _internal_node(5, upper_children) + body
        key = ((up[2] & 0xFFFFFFFF) >> 12) | (((up[1] & 0xFFFFFFFF) >> 12) << 21) | (
            ((up[0] & 0xFFFFFFFF) >> 12) << 42)
        tiles.append(struct.pack("<QqIf8x", key, upper_rel, 0, 0.0))

    root = bytearray(ROOT_DATA_SIZE)
    struct.pack_into("<6iIf", root, 0, *imin, *imax, len(tiles), 0.0)
    tree_data = struct.pack("<4Q3I3IQ", 0, 0, 0, TREE_DATA_SIZE,
                            sum(len(lw) for lw in tree.values()), len(tree), len(leaves),
                            0, 0, 0, int(dense.size))
    body = tree_data + bytes(root) + b"".join(tiles) + bytes(nodes)
    grid = bytearray(GRID_DATA_SIZE)
    struct.pack_into("<QQIIIIQ", grid, 0, MAGIC_GRID, 0, VERSION, 0, 0, 1,
                     GRID_DATA_SIZE + len(body))
    grid = bytes(grid) + body
    if not file_header:
        return grid
    name = b"density"
    meta = bytearray(176)
    struct.pack_into("<QQQQII", meta, 0, len(grid), 16 + 176 + len(name) + len(grid), 0,
                     int(dense.size), 1, 2)
    struct.pack_into("<I", meta, 168, len(name))
    return struct.pack("<QIHH", MAGIC, VERSION, 1, 0) + bytes(meta) + name + grid


def write_nvdb(path, dense: np.ndarray, index_min=(0, 0, 0), gzip_wrap: bool = False,
               file_header: bool = True) -> Path:
    """Write ``nvdb_bytes`` to path (gzip-wrapped if asked); returns the path."""
    raw = nvdb_bytes(dense, index_min, file_header)
    path = Path(path)
    path.write_bytes(gzip.compress(raw) if gzip_wrap else raw)
    return path
