"""mmhand_torch's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one.  The file imports
no JAX, so it runs where only torch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets up JAX for the other files.)
"""

import copy

import numpy as np
import pytest
import torch

from mmhand_torch.config import (
    Config,
    DataConfig,
    ModelConfig,
    OptimConfig,
    PrecisionConfig,
)
from mmhand_torch.data.loader import make_prepare_batch
from mmhand_torch.models.check_nets import (
    make_test_pose_resnet,
    pose_resnet_f64,
)
from mmhand_torch.ops.bn_stats import (
    bn_sums,
    bn_sums_backward,
    bn_sums_backward_ref,
    bn_sums_ref,
)
from mmhand_torch.eval import Evaluator, HPEJudge
from mmhand_torch.ops.heatmap import (
    CLIP_LO,
    gaussian_heatmaps,
    gaussian_heatmaps_ref,
    skip_d2,
    skipped_elements,
)
from mmhand_torch.ops.jointsmap import generate_jointsmap, generate_jointsmap_ref
from mmhand_torch.train.state import build_system
from mmhand_torch.train.step import make_train_step


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _off_clip_boundary(uv, height, width, sigma=6.0):
    """Mask of pixels whose unclipped Gaussian (float64) is more than 1e-6
    from the 0.0099 clip, where a last-bit difference cannot flip it."""
    rows = np.arange(height, dtype=np.float64)[:, None, None]
    cols = np.arange(width, dtype=np.float64)[None, :, None]
    uv = np.asarray(uv, np.float64)
    d2 = ((cols - uv[:, None, None, :, 0]) ** 2
          + (rows - uv[:, None, None, :, 1]) ** 2)
    return np.abs(np.exp(-d2 / (2 * sigma * sigma)) - CLIP_LO) > 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("batch,height,width", [(16, 256, 256), (3, 70, 90)])
def test_heatmap_kernel_matches_plain(cuda, batch, height, width):
    """atol 1e-6: the plain version on CUDA divides by 2 sigma^2 as a
    multiply by its reciprocal, the kernel divides; a last-bit difference
    before exp."""
    uv_np = np.random.RandomState(7).uniform(
        -10, width + 10, (batch, 21, 2)).astype(np.float32)
    uv = torch.from_numpy(uv_np).to(cuda)
    before = gaussian_heatmaps.launches
    got = gaussian_heatmaps(uv, height, width, 6.0)
    torch.cuda.synchronize()
    assert gaussian_heatmaps.launches == before + 1
    assert got.shape == (batch, height, width, 21) and got.is_cuda
    want = gaussian_heatmaps_ref(uv, height, width, 6.0)
    keep = _off_clip_boundary(uv_np, height, width)
    np.testing.assert_allclose(np.where(keep, got.cpu().numpy(), 0),
                               np.where(keep, want.cpu().numpy(), 0),
                               rtol=0, atol=1e-6)


# keypoints for K1's early-out (tests/test_torch_ops.py runs them on the CPU)
HEAT_SKIP_CASES = ["inside", "edges", "off_frame", "near_threshold"]


def _heatmap_skip_case(case, sigma, batch, height, width, seed=11):
    """(batch, 21, 2) keypoints: fractional ones inside the frame, on its
    edges and corners, off it, or placed so that pixel (30, 10) lies at d^2
    within a few ulps of the early-out threshold, on either side."""
    rng = np.random.RandomState(seed)
    size = np.array([width - 1, height - 1], np.float32)
    uv = rng.uniform(0, 1, (batch, 21, 2)) * size
    if case == "edges":
        side = rng.randint(0, 2, (batch, 21))  # the coordinate on an edge
        edge = rng.randint(0, 2, (batch, 21)) * size[side]
        np.put_along_axis(uv, side[..., None], edge[..., None], -1)
        uv[:, :4] = [[0, 0], [width - 1, 0], [0, height - 1], size]
        uv[:, 4:8] += rng.choice([-0.5, 0.5], (batch, 4, 2))
    elif case == "off_frame":
        far = rng.uniform(0.5, 40, (batch, 21))
        uv[:, :7, 0] = -far[:, :7]
        uv[:, 7:14, 0] = width - 1 + far[:, 7:14]
        uv[:, 14:, 1] = rng.choice([-1, 1], (batch, 7)) * (height + far[:, 14:])
    elif case == "near_threshold":
        t = np.float64(np.float32(skip_d2(sigma)))
        dy = np.arange(21) % int(np.sqrt(t))
        eps = rng.choice([-3e-7, -1e-7, 0.0, 1e-7, 3e-7], (batch, 21))
        uv = np.stack(np.broadcast_arrays(
            30.0 - np.sqrt(t * (1 + eps) - dy * dy), 10.0 - dy), -1)
    return torch.from_numpy(np.asarray(uv, np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", HEAT_SKIP_CASES)
@pytest.mark.parametrize("sigma", [5.0, 6.0])
@pytest.mark.parametrize("batch,height,width", [(16, 256, 256), (3, 70, 90)])
def test_heatmap_kernel_early_out(cuda, case, sigma, batch, height, width):
    """The early-out's hard cases: the kernel within 1e-6 of the plain
    version off the clip boundary, and 0 wherever it skipped, as the plain
    version is; (3, 70, 90) rows are not 16-byte multiples."""
    uv = _heatmap_skip_case(case, sigma, batch, height, width).to(cuda)
    got = gaussian_heatmaps(uv, height, width, sigma)
    torch.cuda.synchronize()
    want = gaussian_heatmaps_ref(uv.cpu(), height, width, sigma)
    skipped = skipped_elements(uv.cpu(), height, width, sigma)
    assert not bool(want[skipped].any())
    assert not bool(got.cpu()[skipped].any())
    keep = _off_clip_boundary(uv.cpu().numpy(), height, width, sigma)
    assert keep.mean() > 1 - 1e-3
    np.testing.assert_allclose(np.where(keep, got.cpu().numpy(), 0),
                               np.where(keep, want.numpy(), 0),
                               rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_heatmap_kernel_checks_its_input(cuda):
    uv = torch.zeros(2, 21, 2, device=cuda)
    with pytest.raises(TypeError):
        gaussian_heatmaps(uv.double())
    with pytest.raises(ValueError):
        gaussian_heatmaps(torch.zeros(2, 21, 3, device=cuda))
    with pytest.raises(ValueError):
        gaussian_heatmaps(uv.transpose(0, 1))
    with pytest.raises(ValueError, match="keypoints"):
        gaussian_heatmaps(torch.zeros(1, 6145, 2, device=cuda), 4, 4)


@pytest.mark.cuda
def test_prepare_batch_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(8)
    raw = {}
    for side in ("src", "tgt"):
        raw[f"{side}_image"] = rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
        raw[f"{side}_depth"] = rng.randint(0, 700, (2, 32, 32)).astype(np.uint16)
        raw[f"{side}_uv"] = rng.uniform(4, 28, (2, 21, 2)).astype(np.float32)
    got = make_prepare_batch(6.0, cuda)(raw)
    want = make_prepare_batch(6.0, "cpu")(raw)
    # CUDA divides by a Python scalar as a multiply by its reciprocal: 2 ulps
    for k in ("H1", "D1", "H2", "D2"):
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].numpy(),
                                   rtol=0, atol=2.5e-7, err_msg=k)
    for k, uv in (("P1", raw["src_uv"]), ("P2", raw["tgt_uv"])):
        keep = _off_clip_boundary(uv, 32, 32)
        np.testing.assert_allclose(np.where(keep, got[k].cpu().numpy(), 0),
                                   np.where(keep, want[k].numpy(), 0),
                                   rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((16, 64, 256, 256), torch.bfloat16),   # the train step's largest site
    ((16, 64, 256, 256), torch.float16),    # the same in the fp16 slice
    ((16, 512, 64, 64), torch.bfloat16),    # a PATBlock attention stream
    ((4, 128, 32, 32), torch.float16),
    ((3, 29, 37, 41), torch.float32)])      # ragged N and C
def test_bn_kernels_match_plain(cuda, shape, dtype):
    """K2 against the plain sums: f32 sums in another order, held relative
    to sum |x| and sum x^2 at 1e-5.  K2b against the plain formula: the same
    operations in the same order, so bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = (torch.randn(shape, generator=gen, device=cuda) * 1.5 + 0.3).to(
        dtype).contiguous(memory_format=torch.channels_last)
    before = (bn_sums.launches, bn_sums_backward.launches)
    s1, s2 = bn_sums(x)
    g1 = torch.randn(shape[1], generator=gen, device=cuda)
    g2 = torch.randn(shape[1], generator=gen, device=cuda)
    dx = bn_sums_backward(x, g1, g2)
    torch.cuda.synchronize()
    assert (bn_sums.launches, bn_sums_backward.launches) == (
        before[0] + 1, before[1] + 1)
    r1, r2 = bn_sums_ref(x)
    assert float(((s1 - r1).abs() / x.float().abs().sum((0, 2, 3))).max()) <= 1e-5
    assert float(((s2 - r2).abs() / r2).max()) <= 1e-5
    assert dx.dtype == dtype and dx.is_contiguous(
        memory_format=torch.channels_last)
    assert torch.equal(dx, bn_sums_backward_ref(x, g1, g2))
    again = bn_sums(x)  # no atomics: the same sums on every run
    assert torch.equal(again[0], s1) and torch.equal(again[1], s2)


@pytest.mark.cuda
def test_bn_kernels_refuse_other_layouts(cuda):
    x = torch.randn(2, 8, 4, 4, device=cuda)
    with pytest.raises(ValueError, match="channels_last"):
        bn_sums(x)
    with pytest.raises(ValueError, match="channels_last"):
        bn_sums_backward(x, torch.zeros(8, device=cuda),
                         torch.zeros(8, device=cuda))
    with pytest.raises(TypeError):
        bn_sums(x.double().contiguous(memory_format=torch.channels_last))


@pytest.mark.cuda
def test_toy_train_step_on_card_matches_cpu(cuda):
    """Two toy steps from the same weights and batches, f32 with TF32 off:
    losses within the tests' 2e-4 against JAX, parameters as
    tests/test_torch_train.py holds them against JAX (Adam lets f32
    rounding decide the update of elements whose gradient is near zero)."""
    cfg = Config(model=ModelConfig(fine_size=32, ngf=8, ndf=8, g_n_blocks=2,
                                   n_layers_d=2, use_dropout_g=False,
                                   use_dropout_d=False),
                 optim=OptimConfig(pool_size=0),
                 data=DataConfig(dataset="synthetic"),
                 precision=PrecisionConfig(compute_dtype="float32"))
    with pytest.warns(UserWarning, match="RANDOM VGG19"):
        on_cpu = build_system(cfg, "cpu")
    with pytest.warns(UserWarning, match="RANDOM VGG19"):
        on_card = build_system(cfg, cuda)
    rng = np.random.RandomState(9)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for _ in range(2):
            batch = {k: torch.from_numpy(rng.uniform(
                -1 if k[0] != "P" else 0, 1, (2, 32, 32, 21 if k[0] == "P"
                                              else 3)).astype(np.float32))
                for k in ("H1", "P1", "D1", "H2", "P2", "D2")}
            want = make_train_step(on_cpu)(batch, 2e-4)
            got = make_train_step(on_card)(
                {k: v.to(cuda) for k, v in batch.items()}, 2e-4)
            for k, v in want.items():
                np.testing.assert_allclose(float(got[k]), float(v), rtol=2e-4,
                                           atol=2e-4, err_msg=k)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for name in ("generator", "d_pb", "d_pp"):
        a = getattr(on_card, name).state_dict()
        b = getattr(on_cpu, name).state_dict()
        outside = total = 0
        for k, v in b.items():
            if k.endswith("num_batches_tracked"):
                continue
            diff = (a[k].cpu() - v).abs()
            atol = 1e-5 if "running" in k else 2e-5
            outside += int((diff > atol + 1e-3 * v.abs()).sum())
            total += v.numel()
            assert float(diff.max()) <= 2 * 2e-4 * 2, f"{name}.{k}"
        assert outside <= 0.005 * total, f"{name}: {outside} of {total}"


@pytest.mark.cuda
def test_train_state_on_card_restores_tensor_for_tensor(cuda, tmp_path):
    """A train state saved from the card and loaded with map_location onto
    the card: nets, Adams, pools, random streams, scales and step equal the
    saved ones, and a step runs after the restore."""
    from mmhand_torch.utils.checkpoint import CheckpointManager

    cfg = Config(model=ModelConfig(fine_size=32, ngf=8, ndf=8, g_n_blocks=1,
                                   n_layers_d=1),
                 optim=OptimConfig(pool_size=3),
                 data=DataConfig(dataset="synthetic"),
                 precision=PrecisionConfig(compute_dtype="float16",
                                           loss_scaling=True))
    with pytest.warns(UserWarning, match="RANDOM VGG19"):
        system = build_system(cfg, cuda)
    rng = np.random.RandomState(4)
    batch = {k: torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, c)).astype(
        np.float32)).to(cuda) for k, c in (("H1", 3), ("P1", 21), ("D1", 3),
                                           ("H2", 3), ("P2", 21), ("D2", 3))}
    step = make_train_step(system)
    for _ in range(2):
        step(batch, 2e-4)
    ckpt = CheckpointManager(str(tmp_path), "card")
    ckpt.save(system, "latest")
    with pytest.warns(UserWarning, match="RANDOM VGG19"):
        fresh = build_system(cfg, cuda)
    ckpt.restore(fresh, "latest")

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, f"{prefix}.{k}")
        else:
            yield prefix, tree

    want, got = dict(flat(system.state_dict())), dict(flat(fresh.state_dict()))
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k].cpu(), v.cpu()), k
        else:
            assert got[k] == v, k
    assert fresh.pool_pb.images.is_cuda and fresh.step == 2
    assert all(torch.isfinite(torch.tensor(float(v)))
               for v in make_train_step(fresh)(batch, 2e-4).values())


@pytest.mark.cuda
def test_sync_bn_world_one_over_nccl_equals_plain(cuda):
    """Cross-rank BatchNorm in a NCCL group of one rank: the all-reduces of
    the moments and of their gradients change nothing, so output and input
    gradient equal the plain BatchNorm's bit for bit."""
    import torch.distributed as dist

    from mmhand_torch.models.layers import BatchNorm2d
    from mmhand_torch.parallel.dryrun import free_port
    from mmhand_torch.parallel.sharding import all_reduce_sum

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        plain = BatchNorm2d(64).to(cuda)
        synced = BatchNorm2d(64, cross_rank=True).to(cuda)
        synced.load_state_dict(plain.state_dict())
        gen = torch.Generator(device=cuda).manual_seed(5)
        x = (torch.randn((4, 64, 32, 32), generator=gen, device=cuda)
             ).contiguous(memory_format=torch.channels_last)
        w = torch.randn(x.shape, generator=gen, device=cuda)
        outs = []
        for bn in (plain, synced):
            xr = x.clone().requires_grad_()
            y = bn(xr)
            (y * w).sum().backward()
            outs.append((y.detach(), xr.grad, bn.running_var.clone()))
        before = all_reduce_sum.launches
        synced(x)
        assert all_reduce_sum.launches == before + 1
    finally:
        dist.destroy_process_group()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _jointsmap_case(name, batch, height, width, seed=0):
    """Hand-sized poses, plus the edge cases of tests/test_torch_jointsmap.py:
    crossing bones (occlusion), equal depths (ties), zero-length bones and
    joints parked off the frame (and coincident there); then the cull's
    degenerate cases: bones of length 1e-7 and 5e-7, where (cos, sin) is not
    a unit vector (tiny), half_len at its 1e-3 floor (floor), NaN keypoints
    and depths (nan), long bones crossing the frame (long), and ellipses
    whose tips and sides touch the warp tiles' edges (graze)."""
    rng = np.random.RandomState(seed)
    scale = np.array([width, height], np.float32)
    uv = ((rng.uniform(0.3, 0.7, (batch, 1, 2))
           + rng.normal(0, 0.18, (batch, 21, 2))) * scale).astype(np.float32)
    z = (rng.uniform(300, 700, (batch, 21)) / 700 * 255).astype(np.float32)
    if name == "occlusion":
        uv[:] = -500.0
        z[:] = 1.0e6
        uv[:, 1], uv[:, 2] = [20, 128], [236, 128]
        uv[:, 5], uv[:, 6] = [128, 20], [128, 236]
        z[:, [1, 2]], z[:, [5, 6]] = 0.2, 0.8
    elif name == "tie":
        z[:] = 100.0
    elif name == "zero_length":
        uv[:, 2] = uv[:, 1]
        uv[:, 18] = uv[:, 19] = uv[:, 20] = uv[:, 17]
    elif name == "parked":
        uv[:, 5:] = [-1000.0, 4000.0]
    elif name == "tiny":            # bones 8 (1, 2) and 11 (5, 6)
        uv[:, 1], uv[:, 2] = [1e-7, 0.0], [0.0, 0.0]
        uv[:, 5], uv[:, 6] = [2e-7, 3e-7], [5e-7, -1e-7]
        z[:, [1, 2, 5, 6]] = 50.0
    elif name == "floor":           # bones 14 (9, 10) and 18 (14, 15)
        uv[:, 9] = [width / 2, height / 2]
        uv[:, 10] = uv[:, 9] + [1e-3, 0.0]
        uv[:, 14] = [width / 4 + 0.5, height / 4]
        uv[:, 15] = uv[:, 14] + [0.0, 2e-3]
        z[:, [9, 10, 14, 15]] = 10.0
    elif name == "nan":
        uv[:, 3] = np.nan
        uv[:, 7, 0] = np.nan
        z[:, 12] = np.nan
    elif name == "long":            # bones 5 (17, 18) and 17 (13, 14)
        uv[:, 17], uv[:, 18] = [-3000.0, 0.2 * height], [3000.0, 0.85 * height]
        uv[:, 13], uv[:, 14] = [0.5 * width, -4000.0], [0.4 * width, 4000.0]
        z[:, [13, 14, 17, 18]] = 20.0
    elif name == "graze":           # tiles of 16 x 8 pixels from (0, 0)
        uv[:, 1], uv[:, 2] = [16.0, 40.0], [32.0, 40.0]    # tip at col 32
        uv[:, 5], uv[:, 6] = [70.0, 24.0], [70.0, 48.0]    # tip at row 48
        uv[:, 9], uv[:, 10] = [100.0, 35.0], [120.0, 35.0]  # side on row 40
        uv[:, 13], uv[:, 14] = [44.0, 60.0], [60.0, 76.0]  # diagonal
        z[:, [1, 2, 5, 6, 9, 10, 13, 14]] = 30.0
    return torch.from_numpy(uv), torch.from_numpy(z)


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch,height,width", [
    ("poses", 16, 256, 256), ("poses", 8, 256, 256), ("poses", 3, 70, 90),
    ("occlusion", 2, 256, 256), ("tie", 2, 256, 256),
    ("zero_length", 2, 256, 256), ("parked", 2, 256, 256),
    ("tiny", 2, 256, 256), ("floor", 2, 256, 256), ("nan", 2, 256, 256),
    ("long", 2, 256, 256), ("graze", 2, 256, 256), ("graze", 3, 70, 90)])
def test_jointsmap_kernel_equals_cpu_plain(cuda, name, batch, height, width):
    """K3 against its plain version run on the CPU: bit for bit (one IEEE
    rounding per operation on both).  The plain version run on the card is
    not the yardstick: torch on CUDA divides by a Python scalar as a
    multiply by its reciprocal."""
    uv, z = _jointsmap_case(name, batch, height, width)
    before = generate_jointsmap.launches
    got = generate_jointsmap(uv.to(cuda), z.to(cuda), height, width)
    torch.cuda.synchronize()
    assert generate_jointsmap.launches == before + 1
    assert got.shape == (batch, height, width) and got.is_cuda
    assert torch.equal(got.cpu(), generate_jointsmap_ref(uv, z, height, width))


@pytest.mark.cuda
def test_jointsmap_kernel_checks_its_input(cuda):
    uv, z = torch.zeros(2, 21, 2, device=cuda), torch.zeros(2, 21, device=cuda)
    with pytest.raises(TypeError):
        generate_jointsmap(uv.double(), z.double())
    with pytest.raises(ValueError):
        generate_jointsmap(torch.zeros(2, 20, 2, device=cuda), z[:, :20])
    with pytest.raises(ValueError):
        generate_jointsmap(uv.transpose(0, 1), z.t())
    with pytest.raises(ValueError):
        generate_jointsmap(uv, z.cpu())


@pytest.mark.cuda
def test_evaluator_on_card_matches_cpu(cuda):
    """The conditioning image exactly; Inception, SSIM and the judge's z in
    float32 with TF32 off, to 1e-4 (conv taps summed in another order)."""
    uv, z = _jointsmap_case("poses", 2, 64, 64, seed=3)
    xyz = torch.cat([uv, z[..., None]], -1)
    cond = Evaluator.create_input_image(xyz.to(cuda), 64)
    assert torch.equal(cond.cpu(), Evaluator.create_input_image(xyz, 64))

    with pytest.warns(UserWarning, match="RANDOM"):
        on_cpu = Evaluator(judge=HPEJudge.random_init(size=64, device="cpu"),
                           device="cpu")
    with pytest.warns(UserWarning, match="RANDOM"):
        on_card = Evaluator(judge=HPEJudge.random_init(size=64, device=cuda),
                            device=cuda)
    rng = np.random.RandomState(4)
    gt = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32))
    pred = (gt * 0.8).contiguous()
    for a, b in zip(on_card.inception_forward(pred.to(cuda)),
                    on_cpu.inception_forward(pred)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(
        on_card.ssim_forward(pred.to(cuda), gt.to(cuda)).cpu().numpy(),
        on_cpu.ssim_forward(pred, gt).numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(on_card.judge.predict(pred.to(cuda))[2].cpu().numpy(),
                               on_cpu.judge.predict(pred)[2].numpy(),
                               rtol=1e-4, atol=1e-4 * 64)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["hpm", "hpm3d"])
def test_hpe_step_on_card_matches_cpu(cuda, variant):
    """Two HPE steps at 32 px from the same weights and batches, f32 with
    TF32 off, the sigma-5 heatmaps rendered by K1 on the card: K1 once per
    batch, losses within tests/test_torch_hpe.py's 2e-4, parameters as that
    file holds them against JAX."""
    from mmhand_torch.hpe import (
        HPEMixDataset,
        HPESystem,
        make_hpe_prepare_batch,
        make_hpe_train_step,
    )

    cfg = Config(model=ModelConfig(fine_size=32),
                 data=DataConfig(dataset="synthetic"),
                 precision=PrecisionConfig(compute_dtype="float32"))
    on_cpu = HPESystem(cfg, variant, "cpu")
    on_card = HPESystem(cfg, variant, cuda)
    dataset = HPEMixDataset(cfg, length_for_synthetic=8)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for i in range(2):
            raw = dataset.batch(range(3 * i, 3 * i + 3))
            raw["weight"] = np.array([1, 1 - i, 1], np.int32)
            before = gaussian_heatmaps.launches
            batch = make_hpe_prepare_batch(device=cuda)(raw)
            assert gaussian_heatmaps.launches == before + 1
            want = make_hpe_train_step(on_cpu)(
                make_hpe_prepare_batch(device="cpu")(raw), 2e-4)
            got = make_hpe_train_step(on_card)(batch, 2e-4)
            assert set(got) == set(want)
            for k, v in want.items():
                np.testing.assert_allclose(float(got[k]), float(v), rtol=2e-4,
                                           err_msg=k)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for name in ("hpm2d", "hpm3d"):
        if getattr(on_cpu, name) is None:
            continue
        a = getattr(on_card, name).state_dict()
        b = getattr(on_cpu, name).state_dict()
        outside = total = 0
        for k, v in b.items():
            diff = (a[k].cpu() - v).abs()
            outside += int((diff > 2e-5 + 1e-3 * v.abs()).sum())
            total += v.numel()
            assert float(diff.max()) <= 2 * 2e-4 * 2, f"{name}.{k}"
        assert outside <= 0.005 * total, f"{name}: {outside} of {total}"


@pytest.mark.cuda
def test_pix2pixhd_labels_on_card_equal_plain(cuda, tmp_path):
    """``export_baseline_formats pix2pixhd`` rasterizes its labels with K3
    in batches: the label PNGs equal those of the plain version on the CPU
    byte for byte, one launch per batch."""
    import filecmp
    import os

    from mmhand_torch.data.preprocess import create_rhd_db
    from mmhand_torch.data.raw_sources import write_raw_rhd
    from mmhand_torch.scripts.export_baseline_formats import export_pix2pixhd

    raw = write_raw_rhd(tmp_path / "raw", 8, seed=2)
    crops = str(tmp_path / "crops")
    n = create_rhd_db(raw, crops, 256, workers=4)
    before = generate_jointsmap.launches
    assert export_pix2pixhd(crops, str(tmp_path / "card"), 256, cuda, 4) == n
    assert generate_jointsmap.launches == before + -(-n // 4)
    export_pix2pixhd(crops, str(tmp_path / "cpu"), 256, "cpu", 4)
    names = sorted(os.listdir(tmp_path / "cpu" / "train_label"))
    assert len(names) == n
    for name in names:
        assert filecmp.cmp(tmp_path / "card" / "train_label" / name,
                           tmp_path / "cpu" / "train_label" / name,
                           shallow=False), name


def _on_card(net, cuda):
    return copy.deepcopy(net).to(device=cuda, memory_format=torch.channels_last)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["patn2", "pose_resnet50"])
def test_zoo_forward_on_card_matches_cpu(cuda, arch):
    """PATN2Stream (full width) and PoseResNet-50 in eval mode, float32
    with TF32 off, to 1e-4 (conv taps summed in another order)."""
    from mmhand_torch.eval.evaluator import full_fp32
    from mmhand_torch.models.baselines import PATN2Stream
    from mmhand_torch.models.layers import init_weights

    rng = np.random.RandomState(5)
    if arch == "patn2":
        gen = torch.Generator().manual_seed(1)
        net = init_weights(PATN2Stream(compute_dtype=None), "normal", gen).eval()
        with torch.no_grad():  # a real signal, tanh not saturated
            for m in net.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.normal_(0, 0.05, generator=gen)
                    m.running_var.uniform_(0.1, 1.0, generator=gen)
        x = (torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)),
             torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 42)).astype(np.float32)))
    else:
        net = make_test_pose_resnet(50).eval()
        x = (torch.from_numpy(rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)),)
    card = _on_card(net, cuda)
    with full_fp32():
        want = net(x if arch == "patn2" else x[0])
        got = card(tuple(a.to(cuda) for a in x) if arch == "patn2"
                   else x[0].to(cuda))
    assert got.shape == want.shape and got.std() > 1e-3
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
def test_pose_resnet_train_bn_on_card_equals_plain(cuda):
    """One train-mode forward and backward of PoseResNet-50 in float32 with
    TF32 off: K2 and K2b at its 56 BatchNorms; the output and the running
    statistics it leaves against the plain version on the CPU; the
    gradients against float64."""
    net = make_test_pose_resnet(50, seed=3).train()
    card = _on_card(net, cuda)
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, (2, 32, 32, 21)).astype(np.float32))
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = (bn_sums.launches, bn_sums_backward.launches)
        got = card(x.to(cuda))
        (got * w.to(cuda)).sum().backward()
        torch.cuda.synchronize()
        assert (bn_sums.launches - before[0],
                bn_sums_backward.launches - before[1]) == (56, 56)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    want = net(x)
    (want * w).sum().backward()
    np.testing.assert_allclose(got.detach().cpu().numpy(),
                               want.detach().numpy(), rtol=1e-4, atol=1e-4)
    a, b = card.state_dict(), net.state_dict()
    for k, v in b.items():
        if "running" in k:
            np.testing.assert_allclose(a[k].cpu().numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    # the gradients against float64 (torch's functional BatchNorm): the
    # card's f32 within 4x the CPU's f32, as a share of each tensor's norm;
    # at batch 2 the f32 gradients of this random net lie up to ~15% from
    # float64 in layer4 on the CPU alone
    f64 = copy.deepcopy(net).double()
    (pose_resnet_f64(f64, x.double()) * w.double()).sum().backward()
    for (k, p), q, r in zip(net.named_parameters(), card.parameters(),
                            f64.parameters()):
        scale = float(r.grad.norm())
        e_cpu = float((p.grad.double() - r.grad).norm()) / scale
        e_card = float((q.grad.cpu().double() - r.grad).norm()) / scale
        assert e_card <= 4 * e_cpu + 1e-6, (k, e_card, e_cpu)
