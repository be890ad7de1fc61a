"""Time the grouping kernel on one NVIDIA GPU against the number of
valid centres an image, and count the instructions of its centre loop.

    python3 scripts/grouping_sweep.py [--centres 0,16,32,64,128]

At B=8 and 480 x 640 pixels an image (loc uniform over the image, ~60 %
foreground), for each count n of valid centres (K = n, all valid; n = 0:
K = 64, none valid), holds the loc-level entry
(`ops/cuda/grouping.py::group_pixels_kernel`) against its plain version
on the first image (ids and min_d2 bit for bit) and times it by
`chip_smoke.stream_ms` (the card's time alone). Prints one JSON line
with the card's name and power limit: the times, the least-squares
slope (ms a centre) and intercept over n > 0, the slope in cycles of a
warp's pixel and centre at the card's maximum SM clock, and the SASS
instructions of the loop that reads two centres a trip (cuobjdump of
the library `_build.py` built), over its 2 x PPT pixel-centres. Writes
chiprun_out/grouping_sweep.json. Needs no network and no JAX."""
import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W = 8, 480, 640


def loop_instructions(lib_path: str, nvcc: str):
    """(instructions of the centre loop of the loc entry's f32 instance,
    the pixels a thread) from the library's SASS: the smallest loop (a
    backward branch's body) that holds a 16-byte shared load (two
    centres) and one FFMA (a d2) for each of 2 x PPT pixel-centres."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), 'cuobjdump')
    sass = subprocess.run([cuobjdump, '-sass', lib_path], check=True,
                          capture_output=True, text=True).stdout
    src = open(os.path.join(ROOT, 'nicr_mtsa_tpu_torch', 'ops', 'cuda',
                            'csrc', 'grouping.cu')).read()
    ppt = int(re.search(r'constexpr int PPT = (\d+);', src).group(1))
    for func in re.split(r'\n\s*Function : ', sass)[1:]:
        if 'group_pixels_kernelILb1Eff' not in func.split('\n', 1)[0]:
            continue
        code = [(int(a, 16), text.strip()) for a, text in
                re.findall(r'/\*([0-9a-f]{4,})\*/\s+([^;]*);', func)]
        loops = []
        for addr, text in code:
            m = re.search(r'\bBRA\s+(?:`\()?0x([0-9a-f]+)', text)
            if not m or int(m.group(1), 16) >= addr:
                continue
            body = [t for a, t in code if int(m.group(1), 16) <= a <= addr]
            if any('LDS.128' in t for t in body) and \
                    sum(t.startswith('FFMA') for t in body) == 2 * ppt:
                loops.append(len(body))
        if loops:
            return min(loops), ppt
    raise RuntimeError('grouping_sweep: no centre loop found in the SASS')


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--centres', default='0,16,32,64,128')
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit('grouping_sweep: needs a CUDA device')
    import chip_smoke as cs
    from nicr_mtsa_tpu_torch.ops.cuda import _build
    from nicr_mtsa_tpu_torch.ops.cuda import grouping as grp
    card = cs.card_line()
    print(card, flush=True)
    g = torch.Generator(device='cuda').manual_seed(5)
    P = H * W
    loc_y = torch.rand(B, P, device='cuda', generator=g) * H
    loc_x = torch.rand(B, P, device='cuda', generator=g) * W
    fg = torch.rand(B, P, device='cuda', generator=g) < 0.6
    times = {}
    for n in (int(c) for c in args.centres.split(',')):
        K = n or 64
        ctr = torch.stack([
            torch.randint(0, H, (B, K), device='cuda', generator=g),
            torch.randint(0, W, (B, K), device='cuda', generator=g)],
            -1).float()
        valid = torch.full((B, K), n > 0, device='cuda')
        call = (loc_y, loc_x, ctr, valid, fg)
        first = [t[:1] for t in call]
        got = grp.group_pixels_kernel(*first)
        want = grp.group_pixels_reference(*first)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            sys.exit(f'grouping_sweep: {n} centres differ from the plain '
                     f'version')
        times[n] = cs.stream_ms(lambda: grp.group_pixels_kernel(*call))
    ns = [n for n in times if n > 0]
    slope, intercept = np.polyfit(ns, [times[n] for n in ns], 1)
    mhz = float(subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm',
         '--format=csv,noheader,nounits'], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # a centre's cycles on one of an SM's 4 schedulers, over the warps'
    # pixels it issues for
    warp_pixels = B * P / 32 / (sms * 4)
    cycles = slope * 1e-3 * mhz * 1e6 / warp_pixels
    n_loop, ppt = loop_instructions(str(_build._target('grouping')[1]),
                                    _build._nvcc())
    out = {'card': card, 'batch': B, 'pixels': P, 'stream_ms': times,
           'ms_a_centre': slope, 'intercept_ms': intercept,
           'max_sm_mhz': mhz, 'cycles_a_warp_pixel_centre': cycles,
           'loop_instructions': n_loop,
           'loop_instructions_a_pixel_centre': n_loop / (2 * ppt)}
    print(json.dumps(out), flush=True)
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(ROOT, 'chiprun_out', 'grouping_sweep.json'),
              'w') as f:
        json.dump(out, f, indent=1)


if __name__ == '__main__':
    main()
