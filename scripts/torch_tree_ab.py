"""Time two trees of the PyTorch/CUDA port on one NVIDIA GPU, in turns.

    python3 scripts/torch_tree_ab.py --tree parent=_scratch/parent \\
        --tree change=. --order parent,change,change,parent \\
        [--train-steps 10] [--swin-requests 5] [--requests 10] \\
        [--steps 5] [--kernels-only]

Each turn runs in its own process from the root of the named tree (a
checkout, or a `git archive` unpacked into a directory that .gitignore
lists), builds that tree's kernels and times, on the same inputs made
from a seed:
- row 7's bf16 forward (`window_attention_core_forward`), its backward
  (`window_attention_core_backward`, with the dbias reduction it
  launches) and its dbias reduction alone (`dbias_reduce`, on partials
  of the backward's shape) at the four Swin stages of B=8 480 x 640
  training, shifted v2;
- row 8 (`window_attention_image`, bf16, shifted v2) on the B=8 images
  of the four stages of 480 x 640 serving, and beside it the `'qkv'`
  composite that `--attn-qkv` serving runs for the same function (the
  qkv product and the projection by torch matmuls, the pad, roll and
  partition copies, row 9): a yardstick, not `library_ms`;
- row 9 (`window_attention_qkv`, bf16, v2) at the four stages of B=8
  480 x 640 serving;
- the PyTorch calls for the same work at each stage (chip_smoke.py's
  `library_ms`): F.scaled_dot_product_attention on bf16 (windows,
  heads, 64, 32) q, k, v with a float mask, forward alone and forward +
  backward (q, k, v gradients), and torch.sum over the dbias partials;
- rows 1-6, 10 and 11 at their paths' shapes, on the inputs
  chip_smoke.py's checks make for them (B=8: the finishers' bf16
  logits, channels-last as the heads give them on the card, rows 1
  and 3 also NCHW (`*_nchw`); the grouping's 307200 pixels and 64
  centres, and the whole `ops.grouping.group_pixels` call at the
  serving shape (offsets (8, 2, 480, 640) bf16 channels-last, 64 int32
  centres) with its device launches (`row2_group_pixels`), the eval
  reductions' (8, 40, 480, 640) channels-last logits
  (row 5 to 512 x 512), the LayerNorm's rows at each of its Swin
  serving widths
  (chip_smoke.py's LN_SHAPES: 153600 x 96, 32 and 128, 38400 x 256,
  9600 x 512, 2400 x 1024), the intersection's (8, 262144) slots:
  random with the device launches of one call, every pixel in one bin,
  and the two slot maps one fused eval step passes it (`*_eval`:
  chip_smoke.py phase 5's pipeline and batch)), row 6 also NCHW, with
  F.layer_norm beside row 10 at each shape and torch.bincount beside
  row 11;
each in two ways: `event_ms`, CUDA events around one call (as
chip_smoke.py's `cuda_ms` times a kernel: the wrapper's host time shows
whenever it exceeds the kernel's), and `stream_ms`, a batch of
back-to-back calls queued behind a spin kernel, per call (the card's
time alone). Unless --kernels-only, the turn then runs the tree's own
chip_smoke.py phases 3 (EMSANet serving, B=8), 14 (`--no-defer4x`
serving, B=8), 5 (the fused eval step, B=8), 8 (Swin serving, B=8), 17
(`--attn-qkv` serving, B=8), 11 (Swin training, B=8) and 19 (EMSANet
training, B=8). The stages and shapes are those of this script's own
tree (chip_smoke.py's CORE_CASES, PADDED_STAGES, BLOCK_STAGES and
LN_SHAPES), passed to every turn. A tree under test needs
chip_smoke.py's `_core_inputs`, `_padded_stage_qkv`, `_wab_weights`,
`card_line`, `serve`, `serve_exact`, `evaluate`, `train` and
`EMSANET_TRAIN_LAUNCHES` (or, in a tree without EMSANet training,
`train_swin`: its turns report no `train_emsanet`), `SWIN_KERNELS`,
`QKV_KERNELS` and `DEFER2X_KERNELS` with the signatures this tree's
chip_smoke.py has. Each turn prints one JSON line; all of them, with
the card's name and power limit, go to chiprun_out/tree_ab.json.
Needs no network and no JAX."""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# cycles of the spin kernel queued ahead of a batch (~6 ms at an H100's
# ~1.7 GHz): longer than the host time of a batch of launches
HEAD_START_CYCLES = 10_000_000
N_TIMED, BATCH = 10, 10


def _times(fn):
    """{event_ms, stream_ms}: medians of N_TIMED timings of fn() after a
    warm-up: one call between CUDA events, and a batch of BATCH
    back-to-back calls behind a spin kernel, per call."""
    import numpy as np
    import torch
    fn()
    torch.cuda.synchronize()
    out = {}
    for key, batch in (('event_ms', 1), ('stream_ms', BATCH)):
        times = []
        for _ in range(N_TIMED):
            if batch > 1:
                torch.cuda._sleep(HEAD_START_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(batch):
                fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / batch)
        out[key] = float(np.median(times))
    return out


def _device_launches(fn) -> int:
    """The device activities (kernels, copies, fills) of one fn() call,
    by torch.profiler, after a warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    return int(sum(e.count for e in p.key_averages()
                   if e.device_type == DeviceType.CUDA))


def stages():
    """{'core': {stage: (windows, C, window grid)}, 'qkv' and 'block':
    {stage: (image H, W, C)}, 'ln': row 10's (rows, C, launches)} of B=8
    480 x 640, from this tree's chip_smoke.py (row 9's stage 1 is the
    unpadded 120 x 160 image)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    return {'core': cs.CORE_CASES,
            'qkv': {'stage1': (120, 160, 128), **cs.PADDED_STAGES},
            'block': cs.BLOCK_STAGES, 'ln': cs.LN_SHAPES}


def qkv_composite(wa, waq, x, w, ws: int, shift: int):
    """Row 8's function as `--attn-qkv` serving computes it on a
    (B, H, W, C) image (models/backbones/swin.py `forward_qkv` inside
    `_windowed`): pad, roll, partition, qkv = windows @ Wqkv + b in the
    compute dtype, row 9, out @ Wproj + b, and back. `w`: the weights
    in x's dtype, as `_wab_weights` names them."""
    import torch
    import torch.nn.functional as F
    B, H, W, C = x.shape
    pad_h, pad_w, grid, (sh, sw) = wa.image_windows(H, W, ws, shift)
    y = F.pad(x, (0, 0, 0, pad_w, 0, pad_h)) if pad_h or pad_w else x
    if sh or sw:
        y = torch.roll(y, (-sh, -sw), dims=(1, 2))
    o = waq.window_attention_qkv(
        wa.window_partition(y, ws) @ w['wqkv'] + w['bqkv'], w['bias'],
        w['n_heads'], grid, (sh, sw) if sh or sw else None, w['v2_scale'])
    y = wa.window_unpartition(o @ w['wproj'] + w['bproj'], ws, H + pad_h,
                              W + pad_w)
    if sh or sw:
        y = torch.roll(y, (sh, sw), dims=(1, 2))
    return y[:, :H, :W] if pad_h or pad_w else y


def n_partials(wac, Bw: int, h: int) -> int:
    """The backward's dbias partials a head in the tree under test: its
    `bwd_partition`, or in a tree without one the earlier rule of
    max(1, Bw h // BWD_BLOCKS) windows a block."""
    if hasattr(wac, 'bwd_partition'):
        return wac.bwd_partition(Bw, h)[1]
    wpb = max(1, Bw * h // wac.BWD_BLOCKS)
    return -(-Bw // wpb)


def other_rows(kernels, g, ln_shapes):
    """{row: times} of rows 1-6, 10 and 11 at their paths' shapes (the
    inputs chip_smoke.py's checks make for them; row 10 at each of
    `ln_shapes`, (rows, C, launches) of Swin serving, keyed 'rowsxC'),
    and of the PyTorch calls PERF.md names for rows 10 (F.layer_norm)
    and 11 (torch.bincount of the cells)."""
    import torch
    import torch.nn.functional as F
    rnd = lambda *s: torch.randn(*s, device='cuda', generator=g)
    bf = torch.bfloat16
    out = {}
    x = (rnd(8, 40, 120, 160) * 3).to(bf)
    x_cl = x.contiguous(memory_format=torch.channels_last)
    k1, k2 = rnd(40, 1, 3, 3) * 0.3, rnd(40, 1, 3, 3) * 0.3
    b1, b2 = rnd(40) * 0.1, rnd(40) * 0.1
    out['row1_finisher4x'] = _times(
        lambda: kernels.upsample4x_argmax_score(x_cl, k1, b1, k2, b2))
    out['row1_finisher4x_nchw'] = _times(
        lambda: kernels.upsample4x_argmax_score(x, k1, b1, k2, b2))
    B, P, K = 8, 480 * 640, 64
    rand = lambda *s: torch.rand(*s, device='cuda', generator=g)
    loc_y, loc_x = rand(B, P) * 480, rand(B, P) * 640
    ctr = torch.stack([
        torch.randint(0, 480, (B, K), device='cuda', generator=g),
        torch.randint(0, 640, (B, K), device='cuda', generator=g)],
        -1).float()
    valid, fg = rand(B, K) < 0.7, rand(B, P) < 0.6
    out['row2_grouping'] = _times(lambda: kernels.group_pixels_kernel(
        loc_y, loc_x, ctr, valid, fg))
    from nicr_mtsa_tpu_torch.ops.grouping import group_pixels
    off = (rnd(B, 2, 480, 640) * 8).to(bf).contiguous(
        memory_format=torch.channels_last)
    ctr_i = ctr.to(torch.int32)
    fg_map = fg.view(B, 480, 640)
    call = lambda: group_pixels(ctr_i, valid, off, fg_map)
    out['row2_group_pixels'] = dict(_times(call),
                                    device_launches=_device_launches(call))
    out['row3_finisher4x_bilinear'] = _times(
        lambda: kernels.upsample4x_bilinear_argmax_score(x_cl))
    out['row3_finisher4x_bilinear_nchw'] = _times(
        lambda: kernels.upsample4x_bilinear_argmax_score(x))
    x2 = (rnd(8, 40, 240, 320) * 3).to(bf).contiguous(
        memory_format=torch.channels_last)
    k, b = rnd(40, 1, 3, 3) * 0.3, rnd(40) * 0.1
    out['row4_finisher2x'] = _times(
        lambda: kernels.upsample2x_argmax_score(x2, k, b))
    xe = (rnd(8, 40, 480, 640) * 3).to(bf).contiguous(
        memory_format=torch.channels_last)
    full = (slice(0, 480), slice(0, 640))
    out['row5_resize_reduce'] = _times(
        lambda: kernels.crop_resize_argmax_score(xe, full, 512, 512))
    out['row6_semantic_reduce'] = _times(
        lambda: kernels.semantic_argmax_score(xe))
    xe = xe.contiguous()
    out['row6_semantic_reduce_nchw'] = _times(
        lambda: kernels.semantic_argmax_score(xe))
    del xe
    out['row10_layernorm'], out['row10_library_f_layer_norm'] = {}, {}
    for rows, C, _ in ln_shapes:
        xl = rnd(rows, C).to(bf)
        w, bl = torch.rand(C, device='cuda', generator=g) + 0.5, \
            rnd(C) * 0.1
        wb, bb = w.to(bf), bl.to(bf)
        key = f'{rows}x{C}'
        out['row10_layernorm'][key] = _times(
            lambda: kernels.fused_layer_norm(xl, w, bl))
        out['row10_library_f_layer_norm'][key] = _times(
            lambda: F.layer_norm(xl, (C,), wb, bb, 1e-5))
    Bi, Pi, n = 8, 512 * 512, 128
    gt, pred = (torch.randint(0, n + 1, (Bi, Pi), device='cuda',
                              generator=g, dtype=torch.int32)
                for _ in range(2))

    def bincount():                 # chip_smoke.py's library call
        G = n + 1
        ok = (gt >= 0) & (gt <= n) & (pred >= 0) & (pred <= n)
        img = torch.arange(Bi, device='cuda')[:, None] * (G * G)
        cell = torch.where(ok, img + gt.long() * G + pred.long(),
                           Bi * G * G)
        return torch.bincount(cell.reshape(-1), minlength=Bi * G * G + 1
                              )[:-1].view(Bi, G, G)

    call = lambda: kernels.intersection_matrix_kernel(gt, pred, n, n)
    out['row11_intersection'] = dict(_times(call),
                                     device_launches=_device_launches(call))
    out['row11_library_bincount'] = _times(bincount)
    one = (torch.full_like(gt, 7), torch.full_like(pred, 3))
    out['row11_intersection_one_bin'] = _times(
        lambda: kernels.intersection_matrix_kernel(*one, n, n))
    out['row11_intersection_eval'] = {
        key: _times(lambda: kernels.intersection_matrix_kernel(*m))
        for key, m in zip(('panoptic', 'instance'), eval_slot_maps())}
    return out


def eval_slot_maps():
    """The (gt slots, pred slots, n_gt, n_pred) that one fused eval step
    (chip_smoke.py phase 5's pipeline and B=8 batch) passes row 11: one
    call for the panoptic and one for the instance PQ helper."""
    import torch
    from nicr_mtsa_tpu_torch.metrics import pq
    from nicr_mtsa_tpu_torch.pipeline import build_eval_pipeline
    from nicr_mtsa_tpu_torch.testing import build_eval_batch
    pipe = build_eval_pipeline(device='cuda', seed=0)
    eb = build_eval_batch(8, (480, 640), (512, 512), 40,
                          tuple(i < 8 for i in range(40)), seed=0,
                          segment_table_size=128, device='cuda')
    inner, maps = pq.intersection_matrix, []

    def hooked(gt_slots, pred_slots, n_gt, n_pred):
        B = gt_slots.shape[0]
        maps.append((gt_slots.reshape(B, -1).clone(),
                     pred_slots.reshape(B, -1).clone(), n_gt, n_pred))
        return inner(gt_slots, pred_slots, n_gt, n_pred)

    pq.intersection_matrix = hooked
    try:
        pipe.make_fused_eval_step(eb.static_batch)(
            eb.batch, pipe.empty_metric_states())
        torch.cuda.synchronize()
    finally:
        pq.intersection_matrix = inner
    return maps


def child(args) -> None:
    """One turn, from the tree's root (the working directory)."""
    sys.path.insert(0, os.getcwd())
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from nicr_mtsa_tpu_torch.ops import cuda as kernels
    from nicr_mtsa_tpu_torch.ops.cuda import (window_attention as wa,
                                              window_attention_core as wac,
                                              window_attention_qkv as waq)
    build_s = kernels.build_all()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {'tree': args.child, 'build_s': build_s, 'row7_fwd': {},
           'row7_bwd': {}, 'row7_dbias': {}, 'row8': {},
           'qkv_composite': {}, 'row9': {}, 'sdpa': {}, 'sdpa_fwd_bwd': {},
           'torch_sum': {}}
    table = json.loads(args.stages)
    g = torch.Generator(device='cuda').manual_seed(9)
    for stage, (Bw, C, grid) in table['core'].items():
        q, k, v, do, bias = cs._core_inputs(g, Bw, C, torch.bfloat16)
        fargs = (q, k, v, bias, grid, (4, 4))
        out['row7_fwd'][stage] = _times(
            lambda: wac.window_attention_core_forward(*fargs))
        bargs = (q, k, v, bias, do,
                 wac.window_attention_core_forward(*fargs)[1], grid, (4, 4))
        out['row7_bwd'][stage] = _times(
            lambda: wac.window_attention_core_backward(*bargs))
        h = C // 32
        parts = torch.randn(n_partials(wac, Bw, h), h, 64, 64,
                            device='cuda', generator=g)
        out['row7_dbias'][stage] = _times(lambda: wac.dbias_reduce(parts))
        out['torch_sum'][stage] = _times(lambda: parts.sum(0))
        heads = [torch.randn(Bw, h, 64, n, device='cuda', generator=g,
                             dtype=torch.bfloat16)
                 for n in (32, 32, 32, 64, 32)]
        out['sdpa'][stage] = _times(lambda: F.scaled_dot_product_attention(
            *heads[:3], attn_mask=heads[3], scale=1.0))
        leaves = [t.clone().requires_grad_() for t in heads[:3]]

        def sdpa_fwd_bwd():
            for t in leaves:
                t.grad = None
            F.scaled_dot_product_attention(
                *leaves, attn_mask=heads[3], scale=1.0).backward(heads[4])

        out['sdpa_fwd_bwd'][stage] = _times(sdpa_fwd_bwd)
    for stage, (Hs, Ws, C) in table['block'].items():
        w = {k: (v.to(torch.bfloat16) if k in ('wqkv', 'bqkv', 'wproj',
                                                'bproj') else v)
             for k, v in cs._wab_weights(g, C, True, 8).items()}
        x = torch.randn(8, Hs, Ws, C, device='cuda', generator=g,
                        dtype=torch.bfloat16)
        out['row8'][stage] = _times(lambda: wa.window_attention_image(
            x=x, ws=8, shift=4, **w))
        out['qkv_composite'][stage] = _times(
            lambda: qkv_composite(wa, waq, x, w, 8, 4))
    for stage, (Hs, Ws, C) in table['qkv'].items():
        h = C // 32
        qkv, grid = cs._padded_stage_qkv(g, 8, Hs, Ws, C, 8, 4,
                                         torch.bfloat16)
        bias = 16 * torch.sigmoid(torch.randn(h, 64, 64, device='cuda',
                                              generator=g))
        scale = torch.full((h,), 10.0, device='cuda')
        out['row9'][stage] = _times(lambda: waq.window_attention_qkv(
            qkv, bias, h, grid, (4, 4), scale))
    out['rows'] = other_rows(kernels,
                             torch.Generator(device='cuda').manual_seed(11),
                             table['ln'])
    if not args.kernels_only:
        from nicr_mtsa_tpu_torch.pipeline import (emsaformer_bench_config,
                                                  emsanet_bench_config)
        card, result = cs.card_line(), {}
        paths = argparse.Namespace(requests=args.requests, steps=args.steps,
                                   profile=False)
        cs.serve(paths, kernels, card, result)
        cs.serve_exact(emsanet_bench_config(defer=True), args.requests,
                       cs.DEFER2X_KERNELS, kernels, card, result,
                       'serving_defer2x')
        cs.evaluate(paths, kernels, card, result)
        cs.serve_exact(emsaformer_bench_config(), args.swin_requests,
                       cs.SWIN_KERNELS, kernels, card, result,
                       'serving_swin')
        cs.serve_exact(emsaformer_bench_config(attn_backend='qkv'),
                       args.swin_requests, cs.QKV_KERNELS, kernels, card,
                       result, 'serving_qkv')
        train_args = argparse.Namespace(train_steps=args.train_steps,
                                        profile=False)
        keys = ['serving', 'serving_defer2x', 'eval', 'serving_swin',
                'serving_qkv', 'train_swin']
        if hasattr(cs, 'train'):
            from nicr_mtsa_tpu_torch.pipeline import emsanet_train_config
            cs.train(train_args, kernels, card, result, 'train_swin')
            cs.train(train_args, kernels, card, result, 'train_emsanet',
                     emsanet_train_config(),
                     dict.fromkeys(kernels.KERNELS,
                                   cs.EMSANET_TRAIN_LAUNCHES))
            keys.append('train_emsanet')
        else:                       # a tree without EMSANet training
            cs.train_swin(train_args, kernels, card, result)
        for key in keys:
            out[key] = {k: result[key][k] for k in
                        ('frames_per_s', 'rounds_frames_per_s')}
    print('TREE_AB ' + json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tree', action='append', default=[],
                    help='NAME=PATH of a tree to time (repeatable)')
    ap.add_argument('--order', default='parent,change,change,parent',
                    help='the turns, by tree name')
    ap.add_argument('--train-steps', type=int, default=10)
    ap.add_argument('--swin-requests', type=int, default=5)
    ap.add_argument('--requests', type=int, default=10)
    ap.add_argument('--steps', type=int, default=5)
    ap.add_argument('--kernels-only', action='store_true')
    ap.add_argument('--child', help=argparse.SUPPRESS)
    ap.add_argument('--stages', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args)

    import torch
    if not torch.cuda.is_available():
        sys.exit('torch_tree_ab: needs a CUDA device')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    trees = dict(t.split('=', 1) for t in args.tree)
    table = json.dumps(stages())
    turns = []
    for name in args.order.split(','):
        t0 = time.perf_counter()
        cmd = [sys.executable, os.path.abspath(__file__), '--child', name,
               '--train-steps', str(args.train_steps),
               '--swin-requests', str(args.swin_requests),
               '--requests', str(args.requests), '--steps', str(args.steps),
               '--stages', table]
        if args.kernels_only:
            cmd.append('--kernels-only')
        proc = subprocess.run(cmd, cwd=trees[name], capture_output=True,
                              text=True)
        lines = [ln[len('TREE_AB '):] for ln in proc.stdout.splitlines()
                 if ln.startswith('TREE_AB ')]
        if proc.returncode != 0 or not lines:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
            sys.exit(f'torch_tree_ab: turn {name} failed')
        turn = json.loads(lines[-1])
        turn['seconds'] = time.perf_counter() - t0
        turns.append(turn)
        print(json.dumps(turn), flush=True)
    os.makedirs('chiprun_out', exist_ok=True)
    with open(os.path.join('chiprun_out', 'tree_ab.json'), 'w') as f:
        json.dump({'card': card, 'trees': trees, 'turns': turns}, f,
                  indent=1)


if __name__ == '__main__':
    main()
