"""The planner of the one-launch GroupNorm kernels (``ops/group_norm.py``
``plan``, for ``csrc/group_norm_sm90.cu``), on the CPU: every GroupNorm site
of the clouds UNet at 256 and 512 px, in bf16 and f32, both directions, gets
a launch that fits the H100 (shared memory, resident blocks, chunks,
scratch), and no site routes to the old body."""

import dataclasses

import pytest
import torch

from eo_diffusion_torch.cli.presets import get_preset
from eo_diffusion_torch.models.unet import UNet
from eo_diffusion_torch.ops import group_norm as G
from eo_diffusion_torch.tools.bench_group_norm import collect_sites

# (x [N, HW, C], groups, sites) of one forward of sen12mscr256 at batch 8, as
# bench_group_norm collects them; 56 sites at each size
SITES = {
    256: [((8, 1024, 1024), 2), ((8, 1024, 384), 1), ((8, 1024, 512), 16), ((8, 1024, 896), 1),
          ((8, 16384, 128), 1), ((8, 16384, 256), 6), ((8, 16384, 384), 1), ((8, 16384, 512), 1),
          ((8, 16384, 640), 1), ((8, 4096, 256), 1), ((8, 4096, 384), 11), ((8, 4096, 640), 1),
          ((8, 4096, 768), 1), ((8, 4096, 896), 1), ((8, 65536, 128), 8), ((8, 65536, 256), 2),
          ((8, 65536, 384), 1)],
    512: [((8, 16384, 256), 1), ((8, 16384, 384), 11), ((8, 16384, 640), 1),
          ((8, 16384, 768), 1), ((8, 16384, 896), 1), ((8, 262144, 128), 8),
          ((8, 262144, 256), 2), ((8, 262144, 384), 1), ((8, 4096, 1024), 2), ((8, 4096, 384), 1),
          ((8, 4096, 512), 16), ((8, 4096, 896), 1), ((8, 65536, 128), 1), ((8, 65536, 256), 6),
          ((8, 65536, 384), 1), ((8, 65536, 512), 1), ((8, 65536, 640), 1)],
}
CASES = [(size, shape) for size, sites in SITES.items() for shape, _ in sites]
SMS = 132


def test_the_table_is_the_unets_sites():
    """The table above is what hooks on a forward collect (on the meta
    device: shapes only, no arithmetic)."""
    preset = get_preset("sen12mscr256")
    for size, sites in SITES.items():
        cfg = dataclasses.replace(preset.unet_config(cond_channels=preset.in_channels),
                                  image_size=size)
        with torch.device("meta"):
            model = UNet(cfg)
        model.set_impl(attn="plain", norm="plain")
        x = torch.zeros(8, size, size, cfg.in_channels, device="meta", dtype=cfg.dtype)
        got = collect_sites(model, x, torch.zeros(8, dtype=torch.long, device="meta"))
        collected = {}
        for (shape, _, groups, _, _), count in got.items():
            assert groups == 32
            collected[shape] = collected.get(shape, 0) + count
        assert collected == dict(sites) and sum(collected.values()) == 56


@pytest.mark.parametrize("size,shape", CASES, ids=[f"{s}px-{'x'.join(map(str, sh))}"
                                                   for s, sh in CASES])
@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_every_site_gets_a_launch_that_fits(size, shape, esize, direction):
    n, hw, c = shape
    tensors = 1 if direction == "fwd" else 2
    p = G.plan(direction, n, hw, c, 32, esize, sms=SMS)
    assert p.mode in ("resident", "l2", "hbm")  # the one-launch body: no route to the old one
    assert p.mode == "resident" if p.held_rows == p.chunk_rows else p.mode != "resident"
    # shared memory: the held rows of each tensor and the scratch, within 227 KB a block
    assert p.smem_bytes == G.smem_bytes(p.held_rows, c, 32, esize, tensors)
    assert tensors * p.held_rows * c * esize < p.smem_bytes <= G.SMEM_PER_BLOCK
    # one block an SM, every block of the grid resident at once
    assert G.model_blocks_per_sm(p.threads, p.smem_bytes) >= 1
    assert p.grid <= SMS * G.model_blocks_per_sm(p.threads, p.smem_bytes)
    wide = direction == "fwd" and p.held_rows < G.WIDE_BELOW * p.chunk_rows
    assert p.threads % 32 == 0 and p.threads <= (G.WIDE_THREADS if wide else G.MAX_THREADS)
    assert c // p.vec * p.rpi <= p.threads and c % p.vec == 0 and p.vec * esize <= 16
    # chunks: every block of a team owns rows, the last may be short
    assert 1 <= p.teams <= n and p.blocks <= G.MAX_BLOCKS
    assert (p.blocks - 1) * p.chunk_rows < hw <= p.blocks * p.chunk_rows
    assert 0 <= p.held_rows <= p.chunk_rows and (p.held_rows > 0) == (p.pieces > 0)
    assert p.pieces <= min(G.MAX_PIECES, max(p.held_rows, 1))
    # scratch: the counters, then the partials of two rounds
    part = 32 if direction == "fwd" else 32 + c
    assert p.scratch_floats == 2 * G.MAX_TEAMS + 4 * p.teams * p.blocks * part
    assert len(p.ints()) == 12


# the team counts an H100 measured best (tools/profile_group_norm.py)
@pytest.mark.parametrize("direction,shape,esize,teams,mode", [
    ("fwd", (8, 65536, 128), 2, 2, "l2"), ("bwd", (8, 65536, 128), 2, 1, "l2"),
    ("fwd", (8, 16384, 256), 2, 4, "l2"), ("bwd", (8, 16384, 256), 2, 2, "l2"),
    ("fwd", (8, 4096, 384), 2, 8, "resident"), ("fwd", (8, 1024, 512), 2, 8, "resident"),
    ("bwd", (8, 1024, 512), 2, 8, "resident"), ("fwd", (8, 262144, 128), 2, 1, "hbm"),
])
def test_plans_what_the_card_measured_best(direction, shape, esize, teams, mode):
    p = G.plan(direction, *shape, 32, esize, sms=SMS)
    assert (p.teams, p.mode) == (teams, mode)


def test_rows_that_are_not_whole_16_bytes_are_not_held():
    """A bulk copy moves whole rows of 16-byte multiples: 36 bf16 channels
    (72 bytes) are re-read instead."""
    p = G.plan("fwd", 2, 17, 36, 12, 2)
    assert (p.held_rows, p.pieces) == (0, 0) and p.vec == 4


def test_a_row_wider_than_a_block_raises():
    """4099 odd channels are 4099 one-channel vectors a row, past 512 threads
    (as the old body refused them)."""
    with pytest.raises(RuntimeError, match="wider than a block"):
        G.plan("fwd", 1, 4, 4099, 1, 4)
    with pytest.raises(ValueError, match="direction"):
        G.plan("sideways", 1, 4, 64, 32, 2)


@pytest.mark.parametrize("shape,threads", [((8, 262144, 128), 1024), ((8, 65536, 384), 1024),
                                           ((8, 65536, 128), 512), ((8, 1024, 512), 512)])
def test_a_forward_that_re_reads_takes_the_wide_block(shape, threads):
    """Up to 1024 threads where a fifth of a chunk's rows or more are re-read
    (512 px level 0: 868 of 1986 held), up to 512 where they are held; the
    backward keeps 512 (whole rows of C / 8 vectors a block)."""
    vecs = shape[2] // 8
    whole = lambda t: -(-(t // vecs * vecs) // 32) * 32
    assert G.plan("fwd", *shape, 32, 2).threads == whole(threads)
    assert G.plan("bwd", *shape, 32, 2).threads == whole(512)


def test_a_fixed_team_count_is_taken():
    p = G.plan("fwd", 8, 65536, 128, 32, 2, teams=4)
    assert p.teams == 4 and p.blocks == 33 and p.mode == "hbm"
