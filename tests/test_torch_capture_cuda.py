"""The chunk driver's CUDA graphs on the card: the flagship at 8,000 bodies
replayed from graphs (``graphs.CapturedStep``) against two eager runs from
the same state, as ``chip_smoke.py`` [35] does at 100k.  Runs only where
CUDA is available (the ``cuda_device`` fixture skips without a card,
decided at run time); imports no JAX, so that it runs on the machine with
the card: ``python3 -m pytest --noconftest -q
tests/test_torch_capture_cuda.py``.

Tolerance: bit-equal when the two eager runs are bit-equal (the graphs
replay the same kernels on the same inputs), else within twice their gap.
"""

import pytest

torch = pytest.importorskip("torch")

from mgf_tpu_torch.driver import AdaptiveChunkStepper  # noqa: E402
from mgf_tpu_torch.math3d import tree_map  # noqa: E402
from mgf_tpu_torch.ops import solver_sweep  # noqa: E402
from mgf_tpu_torch.scenes import stress_scene  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and kernels, no CPU "
                    "mode)")
    return torch.device("cuda")


def test_flagship_replay_matches_eager_on_card(cuda_device):
    """stress_scene(8_000), 64 steps in chunks of 16 through
    AdaptiveChunkStepper: eager twice and replayed from graphs once from
    the same state; K1's launches equal on all three where the eager runs
    are bit-equal."""
    world, cfg = stress_scene(8000, device=cuda_device)

    def drive(capture):
        st = AdaptiveChunkStepper(cfg, chunk=16, light=True, capture=capture)
        w = world._replace(bodies=tree_map(torch.clone, world.bodies),
                           bp=tree_map(torch.clone, world.bp),
                           warm=tree_map(torch.clone, world.warm))
        torch.cuda.synchronize()
        before = solver_sweep.LAUNCHES
        for _ in range(4):
            w, m = st.step_chunk(w)
        torch.cuda.synchronize()
        return w, st, solver_sweep.LAUNCHES - before

    (a, _, na), (b, _, nb), (c, st, nc) = (drive(False), drive(False),
                                           drive(None))
    assert st.run_chunk.captured.replays > 0 and nc > 0
    xs = [torch.stack([*w.bodies.x, *w.bodies.v, *w.bodies.omega])
          for w in (a, b, c)]
    if torch.equal(xs[0], xs[1]):
        assert torch.equal(xs[0], xs[2])
        assert na == nb == nc
    else:
        gap = float((xs[0] - xs[1]).abs().max())
        assert float((xs[0] - xs[2]).abs().max()) <= 2 * gap
