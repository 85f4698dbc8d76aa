"""Which kernel the 1x1 backward wrappers launch, and how wgrad splits M:
plain Python functions of pallas_conv, checked without a card."""

import pytest
import torch

from deeplearning4j_tpu_torch.nn.helpers import pallas_conv as tpc

# (H=W, K, N) of ResNet-50's 1x1 stride-1 convs at 224x224; the backward
# of each has dgrad and wgrad over M = batch*H*W rows
RESNET50_1X1 = [(56, 64, 256), (56, 256, 64), (56, 64, 64),
                (28, 128, 512), (28, 512, 128),
                (14, 256, 1024), (14, 1024, 256),
                (7, 512, 2048), (7, 2048, 512)]
CASES = [(batch, h, k, n) for batch in (32, 128) for h, k, n in RESNET50_1X1]
IDS = [f"b{b}_{h}x{h}_{k}to{n}" for b, h, k, n in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_resnet50_bf16_backward_takes_the_wgmma_route(case):
    batch, h, k, n = case
    assert tpc.backward_route(torch.bfloat16, batch * h * h, k, n) == "wgmma"


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_resnet50_f32_backward_takes_the_simple_route(case):
    batch, h, k, n = case
    assert tpc.backward_route(torch.float32, batch * h * h, k, n) == "simple"


@pytest.mark.parametrize("shape,aligned,want", [
    ((77, 13, 9), True, "simple"),       # odd K and N
    ((1100, 72, 136), True, "simple"),   # K, N not multiples of 64
    ((1100, 64, 96), True, "simple"),
    ((1100, 64, 192), True, "wgmma"),    # multiples of 64, not of 128
    ((1100, 192, 64), True, "wgmma"),
    ((1100, 512, 2048), False, "simple"),   # an operand off 16 bytes
    ((0, 64, 64), True, "simple"),
], ids=["odd", "k72", "n96", "k64_n192", "k192_n64", "unaligned", "empty"])
def test_backward_route_of_other_shapes(shape, aligned, want):
    assert tpc.backward_route(torch.bfloat16, *shape, aligned) == want


def test_aligned_reads_the_data_pointers():
    base = torch.zeros(64, dtype=torch.bfloat16)
    assert tpc._aligned(base, None)
    assert not tpc._aligned(base, base[1:])   # 2 bytes in


@pytest.mark.parametrize("k,n,tile", [(64, 256, (64, 128)),
                                      (256, 64, (128, 64)),
                                      (64, 64, (64, 64)),
                                      (512, 2048, (128, 128)),
                                      (192, 64, (64, 64))])
def test_wgrad_tile_of_the_wgmma_route(k, n, tile):
    assert tpc.wgrad_tile(k, n, "wgmma") == tile
    assert tpc.wgrad_tile(k, n, "simple") == (64, 64)


@pytest.mark.parametrize("route", ["simple", "wgmma"])
@pytest.mark.parametrize("case", CASES + [(1, 1100, 512, 2048),
                                          (1, 300, 512, 2048),
                                          (1, 77, 13, 9)],
                         ids=IDS + ["m1100_wide", "m300_deep", "odd"])
def test_wgrad_split_ranges_cover_m_in_whole_chunks(route, case):
    batch, h, k, n = case
    m = batch * h * h if batch > 1 else h
    splits = tpc.wgrad_splits(m, k, n, route)
    rows, ranges = tpc.wgrad_split_rows(m, splits)
    assert splits >= 1 and 1 <= ranges <= splits
    assert rows % tpc.WGRAD_CHUNK == 0
    assert (ranges - 1) * rows < m <= ranges * rows
    # the [splits, K, N] f32 scratch stays under its cap when there is one
    assert splits == 1 or splits * k * n <= tpc.WGRAD_SCRATCH
    tk, tn = tpc.wgrad_tile(k, n, route)
    tiles = -(-k // tk) * -(-n // tn)
    # no more ranges than the block target asks for
    assert (splits - 1) * tiles < tpc.WGRAD_BLOCKS or splits == 1


def test_wgrad_splits_on_the_wgmma_route_follow_its_tile():
    # stage-2 shape at batch 128: one 64x64 tile, M split over 528 blocks
    assert tpc.wgrad_splits(401408, 64, 64, "wgmma") == tpc.WGRAD_BLOCKS
    # 7x7 stage: 4 x 16 tiles of 128x128 -> 9 ranges, scratch 36 MB
    assert tpc.wgrad_splits(6272, 512, 2048, "wgmma") == 9
    assert tpc.wgrad_splits(100, 64, 64, "wgmma") == 1


# ResNet-50's 3x3 stride-1 convs at 224x224: (H=W, C), C -> C
RESNET50_3X3 = [(56, 64), (28, 128), (14, 256), (7, 512)]
SERVE_BATCHES = (1, 3, 32, 128)
FWD_1X1 = [(b, h, k, n) for b in SERVE_BATCHES for h, k, n in RESNET50_1X1]
FWD_3X3 = [(b, h, c) for b in SERVE_BATCHES for h, c in RESNET50_3X3]


@pytest.mark.parametrize("case", FWD_1X1,
                         ids=[f"b{b}_{h}x{h}_{k}to{n}" for b, h, k, n in FWD_1X1])
def test_resnet50_bf16_1x1_forward_takes_the_wgmma_route(case):
    batch, h, k, n = case
    assert tpc.forward_route(torch.bfloat16, batch * h * h, k, n) == "wgmma"
    assert tpc.forward_route(torch.float32, batch * h * h, k, n) == "simple"


@pytest.mark.parametrize("case", FWD_3X3,
                         ids=[f"b{b}_{h}x{h}_{c}" for b, h, c in FWD_3X3])
def test_resnet50_bf16_3x3_forward_takes_the_wgmma_route(case):
    batch, h, c = case
    m = batch * h * h
    assert tpc.forward_route(torch.bfloat16, m, c, c, width=h) == "wgmma"
    assert tpc.forward_route(torch.float32, m, c, c, width=h) == "simple"


@pytest.mark.parametrize("args,want", [
    ((77, 13, 9), "simple"),               # odd K and N
    ((200, 72, 136), "simple"),            # K, N not multiples of 64
    ((1100, 64, 96), "simple"),
    ((1100, 64, 192), "wgmma"),            # multiples of 64, not of 128
    ((1100, 192, 64), "wgmma"),
    ((0, 64, 64), "simple"),               # nothing to compute
    ((100, 2 * tpc.FORWARD_MAX_K, 64), "simple"),
], ids=["odd", "k72", "n96", "k64_n192", "k192_n64", "empty", "k_too_deep"])
def test_forward_route_of_other_1x1_shapes(args, want):
    assert tpc.forward_route(torch.bfloat16, *args) == want


@pytest.mark.parametrize("args,width,aligned,want", [
    ((2 * 81, 5, 7), 9, True, "simple"),          # odd C and N
    ((2 * 81, 24, 40), 9, True, "simple"),
    ((2 * 196, 64, 192), 14, True, "wgmma"),      # C = 64 -> N = 192
    ((1 * 64 * 64, 64, 64), 64, True, "simple"),  # wider than the tile
    ((1 * 62 * 62, 64, 64), 62, True, "wgmma"),
    ((32 * 49, 512, 512), 7, False, "simple"),    # an operand off 16 bytes
], ids=["odd", "c24", "c64_n192", "w64", "w62", "unaligned"])
def test_forward_route_of_other_3x3_shapes(args, width, aligned, want):
    assert tpc.forward_route(torch.bfloat16, *args, aligned,
                             width=width) == want


def test_forward_route_counts_reset_with_the_launches():
    tpc.FORWARD_ROUTES["fused_conv3x3"]["wgmma"] = 3
    tpc.LAUNCHES["fused_conv3x3"] = 3
    tpc.reset_launch_counts()
    assert all(v == 0 for r in tpc.FORWARD_ROUTES.values()
               for v in r.values())
    assert set(tpc.FORWARD_ROUTES) == {"fused_conv1x1", "fused_conv3x3"}
    assert set(tpc.LAUNCHES) == {"fused_conv1x1", "fused_conv3x3",
                                 "dgrad_conv1x1", "wgrad_conv1x1"}
