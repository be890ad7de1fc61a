"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--requests N] [--profile]

Drives the port's serving path (nicr_mtsa_tpu_torch) end to end on the
card, in phases; any failure exits non-zero and prints no result:

1. report the card (nvidia-smi name and power limit), build every CUDA
   kernel from nicr_mtsa_tpu_torch/ops/cuda/csrc (one nvcc per source,
   in parallel), pin f32 convs and matmuls to full precision;
2. hold each kernel against its plain PyTorch version on the card at
   the serving path's shapes (finisher idx exact and score within rtol
   1e-5; grouping ids and min_d2 exact) and time both (median of CUDA
   event timings); check that centre selection and the merge resolve
   tied inputs on the card exactly as on the CPU;
3. serve the full-width `emsanet-bench` EMSANet (2x ResNet-34 NBt1D,
   480 x 640, bf16, random weights from a seed) on B=8 uint8/uint16
   requests, with the launch counters set to 0 just before and read
   just after: both kernels must have run;
4. run the same pipeline in f32 on one frame on the card and on the
   CPU with identical weights: semantic_idx must agree on >= 99.9 %.

It prints the kernels line `{"kernels": [...]}` and, last, the result
line `{"ok": true, "device": {...}}`. Details go to
chiprun_out/chip_smoke.json. Needs no network and no JAX."""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores and HBM bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def fail(msg: str) -> None:
    print(f'chip_smoke: FAILED: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, n: int = 10) -> float:
    """Median device time of fn() over n runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def check_finisher(fin, report):
    """Kernel vs plain version at (8, 40, 120, 160), bf16 and f32, plus
    the tie case; times the bf16 case (the serving dtype)."""
    g = torch.Generator(device='cuda').manual_seed(0)
    B, C, H, W = 8, 40, 120, 160
    x = torch.randn(B, C, H, W, device='cuda', generator=g) * 3
    k1 = torch.randn(C, 1, 3, 3, device='cuda', generator=g) * 0.3
    k2 = torch.randn(C, 1, 3, 3, device='cuda', generator=g) * 0.3
    b1 = torch.randn(C, device='cuda', generator=g) * 0.1
    b2 = torch.randn(C, device='cuda', generator=g) * 0.1
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        i_k, s_k = fin.upsample4x_argmax_score(xd, k1, b1, k2, b2)
        torch.cuda.synchronize()
        i_r, s_r = fin.upsample4x_argmax_score_reference(xd, k1, b1, k2, b2)
        n_bad = int((i_k != i_r).sum())
        if n_bad:
            fail(f'finisher {dt}: {n_bad} idx differ from the plain version')
        torch.testing.assert_close(s_k, s_r, rtol=1e-5, atol=0)
        err = max(err, float((s_k - s_r).abs().max()))
    # tie case: classes 2 and 5 equal everywhere -> 2 wins
    xt = torch.zeros(B, 8, H, W, device='cuda', dtype=torch.bfloat16)
    xt[:, 2] = 1.5
    xt[:, 5] = 1.5
    kt = torch.zeros(8, 1, 3, 3, device='cuda')
    kt[:, :, 1, 1] = 1.0
    i_k, _ = fin.upsample4x_argmax_score(xt, kt, None, kt, None)
    torch.cuda.synchronize()
    if not bool((i_k == 2).all()):
        fail('finisher: tied classes did not resolve to the first index')

    xd = x.to(torch.bfloat16)
    ms = cuda_ms(lambda: fin.upsample4x_argmax_score(xd, k1, b1, k2, b2))
    plain_ms = cuda_ms(lambda: fin.upsample4x_argmax_score_reference(
        xd, k1, b1, k2, b2))
    P = B * 16 * H * W                        # output pixels
    # logits read once, two (C, 16) kernels and (C,) biases in f32,
    # idx and score written once
    n_bytes = xd.numel() * xd.element_size() + 2 * C * 17 * 4 + P * 8
    # per output pixel-class: stage-2 taps 4 mul + 3 add + bias add,
    # max, sub, exp, sum add; per stage-1 value 8; per pixel 1 divide
    n_ops = (P * C * (8 + 4) + B * C * (2 * H + 2) * (2 * W + 2) * 8 + P)
    b_ms, b_by = bound(n_bytes, n_ops)
    report['finisher4x'] = dict(
        name='finisher4x', route='cuda',
        source='nicr_mtsa_tpu_torch/ops/cuda/csrc/finisher4x.cu',
        replaces='nicr_mtsa_tpu/ops/pallas/semantic_finisher4x.py:197',
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    print(json.dumps({'phase': 'kernel', **report['finisher4x']}),
          flush=True)


def check_grouping(grp, report):
    """Kernel vs plain version at B=8, P=307200, K=64 with invalid
    centres, plus no valid centres and a ragged P; times the first."""
    g = torch.Generator(device='cuda').manual_seed(1)
    B, P, K = 8, 480 * 640, 64
    loc_y = torch.rand(B, P, device='cuda', generator=g) * 480
    loc_x = torch.rand(B, P, device='cuda', generator=g) * 640
    ctr = torch.stack([
        torch.randint(0, 480, (B, K), device='cuda', generator=g),
        torch.randint(0, 640, (B, K), device='cuda', generator=g)],
        -1).float()
    valid = torch.rand(B, K, device='cuda', generator=g) < 0.7
    fg = torch.rand(B, P, device='cuda', generator=g) < 0.6
    cases = [(loc_y, loc_x, ctr, valid, fg),
             (loc_y, loc_x, ctr, torch.zeros_like(valid), fg),
             (loc_y[:, :100003], loc_x[:, :100003], ctr, valid,
              fg[:, :100003])]
    for i, args in enumerate(cases):
        ids_k, d2_k = grp.group_pixels_kernel(*args)
        torch.cuda.synchronize()
        ids_r, d2_r = grp.group_pixels_reference(*args)
        if not (torch.equal(ids_k, ids_r) and torch.equal(d2_k, d2_r)):
            fail(f'grouping case {i}: ids/min_d2 differ from the plain '
                 f'version')
        if i == 1 and bool((ids_k != 0).any()):
            fail('grouping: ids without any valid centre')
    args = cases[0]
    ms = cuda_ms(lambda: grp.group_pixels_kernel(*args))
    plain_ms = cuda_ms(lambda: grp.group_pixels_reference(*args))
    n_valid = int(valid.sum())                # centres the data needs
    n_bytes = B * P * (4 + 4 + 1 + 4 + 4) + B * K * 9
    n_ops = P * n_valid * 6
    b_ms, b_by = bound(n_bytes, n_ops)
    report['grouping'] = dict(
        name='grouping', route='cuda',
        source='nicr_mtsa_tpu_torch/ops/cuda/csrc/grouping.cu',
        replaces='nicr_mtsa_tpu/ops/pallas/grouping_kernel.py:58',
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    print(json.dumps({'phase': 'kernel', **report['grouping']}),
          flush=True)


def check_ties():
    """First-index tie-breaks on the card: the centre table of a
    heatmap full of tied maxima and the merge's majority vote equal
    the CPU results exactly (torch.topk leaves the order of ties
    undefined on CUDA; the port's selections are stable sorts and
    explicit first-index reductions)."""
    from nicr_mtsa_tpu_torch.ops.merge import deeplab_merge
    from nicr_mtsa_tpu_torch.ops.nms import get_instance_centers
    g = torch.Generator().manual_seed(2)
    shape = (8, 480, 640)
    heat = torch.randint(0, 6, shape, generator=g).float() / 5
    sem = torch.randint(0, 41, shape, generator=g, dtype=torch.int32)
    ins = torch.randint(0, 65, shape, generator=g, dtype=torch.int32)
    fg = torch.rand(shape, generator=g) < 0.5
    thing = (torch.arange(41) > 0) & (torch.arange(41) < 9)
    for name, fn, args in (('centres', get_instance_centers, (heat,)),
                           ('merge', deeplab_merge, (sem, ins, fg, thing))):
        on_cpu = fn(*args)
        on_card = fn(*[a.cuda() for a in args])
        torch.cuda.synchronize()
        for a, b in zip(on_cpu, on_card):
            if not torch.equal(a, b.cpu()):
                fail(f'{name}: card and CPU differ on tied inputs')
    print(json.dumps({'phase': 'ties', 'centres': 'exact',
                      'merge': 'exact'}), flush=True)


def frames(B, H=480, W=640, seed=0):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    depth = rng.integers(0, 2 ** 14, (B, H, W), dtype=np.uint16)
    depth[:, :16] = 0                         # invalid depth rows
    return rgb, depth


def check_outputs(out, B, H, W, n_classes):
    for k in ('panoptic', 'panoptic_semantic', 'panoptic_instance',
              'semantic_idx'):
        if tuple(out[k].shape) != (B, H, W) or out[k].dtype != torch.int32:
            fail(f'{k}: {tuple(out[k].shape)} {out[k].dtype}')
    if not (0 <= int(out['semantic_idx'].min())
            and int(out['semantic_idx'].max()) < n_classes):
        fail('semantic_idx out of range')
    if not (0 <= int(out['panoptic_instance'].min())
            and int(out['panoptic_instance'].max()) <= 64):
        fail('panoptic_instance out of range')
    if int(out['panoptic_semantic'].max()) > n_classes:
        fail('panoptic_semantic out of range')
    s = out['semantic_score']
    if not (bool(torch.isfinite(s).all()) and float(s.min()) > 0
            and float(s.max()) <= 1.0):
        fail('semantic_score not in (0, 1]')
    if tuple(out['scene_logits'].shape) != (B, 10) or \
            not bool(torch.isfinite(out['scene_logits'].float()).all()):
        fail('scene logits not finite (B, 10)')


def serve(args, kernels, card, result):
    from nicr_mtsa_tpu_torch.pipeline import build_serving_pipeline
    B = 8
    pipe = build_serving_pipeline(device='cuda', seed=0)
    rgb, depth = frames(B)
    rgb_t = torch.from_numpy(rgb).cuda()
    depth_t = torch.from_numpy(depth).cuda()
    out = pipe(rgb_t, depth_t)                # warm-up request
    torch.cuda.synchronize()
    check_outputs(out, B, 480, 640, 40)

    # the main path: three timed rounds of N requests, each ending in a
    # device sync on its last output; frames/s is the median round
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(args.requests):
            out = pipe(rgb_t, depth_t)
        int(out['panoptic'][0, 0, 0])
        rounds.append(B * args.requests / (time.perf_counter() - t0))
    launches = {n: fn.launches for n, fn in kernels.KERNELS.items()}
    check_outputs(out, B, 480, 640, 40)
    for n, c in launches.items():
        if c == 0:
            fail(f'kernel {n} was not launched on the serving path')
    fps = float(np.median(rounds))
    result['serving'] = dict(
        batch=B, requests_per_round=args.requests,
        rounds_frames_per_s=rounds,
        frames_per_s=fps, launches=launches, card=card,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        n_instances=[int(v) for v in out['panoptic_instance'].amax(
            dim=(1, 2))])
    print(json.dumps({'phase': 'serve', 'frames_per_s': fps,
                      'rounds_frames_per_s': rounds, 'batch': B,
                      'requests': 3 * args.requests,
                      'launches': launches, 'card': card}), flush=True)
    if args.profile:
        profile(pipe, rgb_t, depth_t, result)
    return launches


def profile(pipe, rgb_t, depth_t, result):
    """Device time by kernel over N requests (torch.profiler), the
    host wall time of the same requests, and the device's idle share.
    Only device events are summed: the CPU ops' rows repeat the time
    of the kernels they launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof
    n = 3
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        for _ in range(n):
            out = pipe(rgb_t, depth_t)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    del out
    rows = []
    n_cpu_ops = 0
    for e in p.key_averages():
        if e.device_type == DeviceType.CUDA:
            rows.append((e.self_device_time_total / n / 1e3, e.key,
                         e.count / n))
        elif e.key.startswith('aten::'):
            n_cpu_ops += e.count
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    result['profile_per_request'] = {
        'device_busy_ms': busy, 'wall_ms_under_profiler': wall_ms,
        'idle_share': 1.0 - busy / wall_ms,
        'kernel_launches': sum(r[2] for r in rows),
        'aten_op_events_nested': n_cpu_ops / n,
        'top': [{'ms': r[0], 'name': r[1][:160], 'calls': r[2]}
                for r in rows[:40]]}
    print(json.dumps({'phase': 'profile', 'device_busy_ms': busy,
                      'wall_ms': wall_ms, 'idle_share': 1 - busy / wall_ms,
                      'top5': [[round(r[0], 3), r[1][:60]]
                               for r in rows[:5]]}), flush=True)


def card_vs_cpu(result):
    """f32 pipeline on one frame, on the card and on the CPU, with the
    same weights (the same seed builds the same model on both)."""
    from nicr_mtsa_tpu_torch.pipeline import (build_serving_pipeline,
                                              emsanet_bench_config)
    cfg = emsanet_bench_config(dtype='float32')
    rgb, depth = frames(1, seed=3)
    outs = {}
    for dev in ('cuda', 'cpu'):
        pipe = build_serving_pipeline(cfg, device=dev, seed=0)
        outs[dev] = {k: v.cpu() for k, v in pipe(rgb, depth).items()}
        del pipe
    check_outputs(outs['cuda'], 1, 480, 640, 40)
    agree = {k: float((outs['cuda'][k] == outs['cpu'][k]).float().mean())
             for k in ('semantic_idx', 'panoptic', 'panoptic_instance')}
    scene_err = float((outs['cuda']['scene_logits']
                       - outs['cpu']['scene_logits']).abs().max())
    result['card_vs_cpu'] = dict(agreement=agree, scene_max_abs=scene_err)
    print(json.dumps({'phase': 'card_vs_cpu', 'agreement': agree,
                      'scene_max_abs': scene_err}), flush=True)
    if agree['semantic_idx'] < 0.999:
        fail(f"semantic_idx card vs CPU agreement {agree['semantic_idx']}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--requests', type=int, default=10,
                    help='requests per timed round (3 rounds)')
    ap.add_argument('--profile', action='store_true',
                    help='also trace two requests with torch.profiler')
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false')
    card = card_line()
    print(card, flush=True)
    t_start = time.perf_counter()

    from nicr_mtsa_tpu_torch.ops import cuda as kernels
    from nicr_mtsa_tpu_torch.ops.cuda import _build, finisher4x, grouping
    build_s = kernels.build_all()
    print(json.dumps({'phase': 'build', 'seconds': build_s}), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    report = {}
    result = {'card': card, 'torch': torch.__version__,
              'cuda': torch.version.cuda, 'build_s': build_s,
              'ptxas': dict(_build.BUILD_LOGS)}
    check_finisher(finisher4x, report)
    check_grouping(grouping, report)
    check_ties()
    launches = serve(args, kernels, card, result)
    card_vs_cpu(result)

    line = {'kernels': [dict(report[n], launches=launches[n])
                        for n in ('finisher4x', 'grouping')]}
    result['kernels'] = line['kernels']
    result['seconds'] = time.perf_counter() - t_start
    os.makedirs('chiprun_out', exist_ok=True)
    with open(os.path.join('chiprun_out', 'chip_smoke.json'), 'w') as f:
        json.dump(result, f, indent=1)
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
