"""The visualisation package of the PyTorch/CUDA port
(nicr_mtsa_tpu_torch.visualization) against the JAX package's, on
seeded numpy inputs, and the port's serving example.

- Every array function, colour generator and palette bit-equal to the
  JAX package's.
- The deliberate divergence: the port's `*_pil` names (and
  `to_pil_img`) return the numpy (H, W, 3) uint8 array where the JAX
  package's return a PIL image; the array equals the JAX image's pixels
  (an indexed image's palette applied).
- `visualize_instance_orientations` draws its text with PIL: equal to
  the JAX package's where PIL is installed; an ImportError naming PIL
  where it is not.
- `python -m nicr_mtsa_tpu_torch.examples.infer_panoptic --cpu`, run
  in-process through `main(argv)`: its three PNGs read back by the
  port's `read_png` equal the visualisation arrays of its outputs."""
import sys

import numpy as np
import pytest
from PIL import Image

import nicr_mtsa_tpu.visualization as jvis
import nicr_mtsa_tpu_torch.visualization as vis
from nicr_mtsa_tpu_torch.data.png import read_png

M = 1 << 16


def _maps(seed=0, H=40, W=56):
    rng = np.random.default_rng(seed)
    semantic = rng.integers(0, 12, (H, W))
    instance = rng.integers(0, 9, (H, W))
    classes = rng.integers(0, 6, (H, W))
    panoptic = classes * M + np.where(classes < 3, instance, 0)
    panoptic[:3] = 0
    return dict(
        semantic=semantic, instance=instance, panoptic=panoptic,
        heat=rng.uniform(-0.2, 1.3, (H, W)).astype(np.float32),
        depth=np.where(rng.uniform(size=(H, W)) < 0.2, 0,
                       rng.integers(1, 9000, (H, W))).astype(np.uint16),
        normal=np.where(rng.uniform(size=(H, W, 1)) < 0.1, 0.0,
                        rng.normal(size=(H, W, 3))).astype(np.float32),
        offset=rng.normal(0, 5, (H, W, 2)).astype(np.float32),
        orientation=rng.normal(size=(H, W, 2)).astype(np.float32))


def _cases(m):
    colors = vis.generate_semantic_colors(12)
    centers = [(3, 4), (39, 55), (20, 0), (0, 30)]
    return {
        'semantic': (('visualize_semantic',), (m['semantic'],), {}),
        'semantic_colors': (('visualize_semantic',), (m['semantic'],),
                            {'colors': colors[::-1]}),
        'heatmap': (('visualize_heatmap',), (m['heat'],), {}),
        'heatmap_range': (('visualize_heatmap',), (m['heat'],),
                          {'min_': 0, 'max_': 1, 'cmap': 'turbo'}),
        'depth': (('visualize_depth',), (m['depth'],), {}),
        'depth_hw1': (('visualize_depth',), (m['depth'][..., None],), {}),
        'normal': (('visualize_normal',), (m['normal'],), {}),
        'instance': (('visualize_instance',), (m['instance'],), {}),
        'center_heat': (('visualize_instance_center',), (m['heat'],), {}),
        'center_cross': (('visualize_instance_center',), (),
                         {'centers': centers, 'height': 40, 'width': 56}),
        'offset': (('visualize_instance_offset',), (m['offset'],), {}),
        'orientation': (('visualize_orientation',), (m['orientation'],), {}),
        'panoptic': (('visualize_panoptic',), (m['panoptic'],), {}),
        'panoptic_tables': (
            ('visualize_panoptic',), (m['panoptic'],),
            {'classes_is_thing': (False, True, True, True, False, False),
             'classes_colors': colors[:6]}),
    }


@pytest.mark.parametrize('case', sorted(_cases(_maps())))
def test_array_functions_match_jax(case):
    m = _maps(seed=1)
    (name,), args, kwargs = _cases(m)[case]
    got = getattr(vis, name)(*args, **kwargs)
    want = getattr(jvis, name)(*args, **kwargs)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # the *_pil twin: the same array where the JAX package gives PIL
    pil_kwargs = {k: v for k, v in kwargs.items() if k != 'cmap'}
    if name + '_pil' in vis.__all__ and not (case == 'heatmap_range'):
        got = getattr(vis, name + '_pil')(*args, **pil_kwargs)
        want = getattr(jvis, name + '_pil')(*args, **pil_kwargs)
        assert isinstance(got, np.ndarray) and isinstance(want, Image.Image)
        np.testing.assert_array_equal(got, np.asarray(want))


def test_colour_generators_match_jax():
    np.testing.assert_array_equal(vis.generate_semantic_colors(41),
                                  jvis.generate_semantic_colors(41))
    np.testing.assert_array_equal(vis.InstanceColorGenerator().palette(300),
                                  jvis.InstanceColorGenerator().palette(300))
    colors = vis.generate_semantic_colors(8)
    is_thing = [False, True, True, False, True, False, False, True]
    gen = vis.PanopticColorGenerator(colors, is_thing)
    jgen = jvis.PanopticColorGenerator(colors, is_thing)
    ids = [0, M + 1, M + 2, 2 * M + 1, 3 * M, M + 1, 9 * M + 3, 7 * M]
    ids += [4 * M + i for i in range(1, 40)]
    assert [gen.get_color(i) for i in ids] == [jgen.get_color(i)
                                              for i in ids]
    # one generator shared over two frames keeps its colours
    m = _maps(2)
    got = [vis.visualize_panoptic(m['panoptic'], shared_color_generator=gen)
           for _ in range(2)]
    want = [jvis.visualize_panoptic(m['panoptic'],
                                    shared_color_generator=jgen)
            for _ in range(2)]
    np.testing.assert_array_equal(got, want)


def test_to_pil_img_returns_the_jax_images_pixels():
    m = _maps(3)
    palette = vis.generate_semantic_colors(12)
    small = m['semantic'].astype(np.uint8)
    cases = ((small, None), (small, palette), (m['depth'], None),
             (m['panoptic'] // M + 300, np.tile(palette, (40, 1))))
    for img, pal in cases:
        got = vis.to_pil_img(img, pal)
        want = jvis.to_pil_img(img, pal)
        if pal is not None:
            want = want.convert('RGB')
            assert got.shape == img.shape + (3,)
        np.testing.assert_array_equal(got, np.asarray(want))


def test_instance_orientation_overlay_needs_pil(monkeypatch):
    m = _maps(4)
    ori = {1: 0.3, 4: -2.0, 8: 3.1, 77: 1.0}
    got = vis.visualize_instance_orientations(m['instance'], ori)
    np.testing.assert_array_equal(
        got, jvis.visualize_instance_orientations(m['instance'], ori))
    np.testing.assert_array_equal(
        vis.visualize_instance_orientations_pil(m['instance'], ori),
        np.asarray(jvis.visualize_instance_orientations_pil(m['instance'],
                                                            ori)))
    monkeypatch.setitem(sys.modules, 'PIL', None)
    with pytest.raises(ImportError, match='PIL'):
        vis.visualize_instance_orientations(m['instance'], ori)
    # nothing else needs it
    vis.visualize_panoptic(m['panoptic'])
    vis.visualize_instance(m['instance'])


def test_infer_panoptic_example_writes_its_images(tmp_path, capsys):
    from nicr_mtsa_tpu_torch.examples import infer_panoptic
    run = infer_panoptic.main(['--cpu', '--out', str(tmp_path),
                               '--size', '64', '96'])
    out = run['outputs']
    assert out['panoptic'].shape == (1, 64, 96)
    _, depth = infer_panoptic.input_frame(64, 96)
    want = infer_panoptic.images(out, depth)
    assert set(want) == {'panoptic.png', 'semantic.png', 'depth.png'}
    for name, img in want.items():
        assert img.shape == (64, 96, 3) and img.dtype == np.uint8
        np.testing.assert_array_equal(read_png(str(tmp_path / name)), img)
        np.testing.assert_array_equal(run['images'][name], img)
    colors = vis.generate_semantic_colors(infer_panoptic.N_CLASSES + 1)
    np.testing.assert_array_equal(
        want['semantic.png'],
        jvis.visualize_semantic(out['semantic_idx'][0].numpy(),
                                colors=colors[1:]))
    assert 'wrote panoptic.png' in capsys.readouterr().out
