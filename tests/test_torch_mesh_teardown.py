"""The ranks `launch.mesh.spawn` starts end cleanly. Every rank collects
its garbage before and after `destroy_process_group` (`mesh._teardown`):
an engine's reference cycles kept the gloo process group, and its
worker and transport threads, alive into interpreter shutdown. That is
the suspected cause of a rare SIGABRT of a rank after it finished its
work (about one world in a thousand), which the few worlds here cannot
show gone: they show that teardown joins the group's threads.
"""
import os

import pytest

from repro_torch.launch.mesh import spawn
import _torch_sharded_cases as S


def _gloo_threads() -> int:
    """Threads of this process that gloo started (by their names)."""
    n = 0
    for t in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{t}/comm") as f:
                n += f.read().startswith(("gloo", "pt_gloo"))
        except OSError:         # the thread ended meanwhile
            pass
    return n


@pytest.mark.parametrize("world", range(3))
def test_finished_ranks_exit_zero(world):
    """A 2-rank world that builds and runs an engine over its mesh:
    `spawn` joins both processes and raises if either exits non-zero,
    so its return means both exited 0, in each of several worlds."""
    ranks = spawn(2, S.engine_rank, 2, device="cpu")
    assert len(ranks) == 2 and ranks[0] == ranks[1]


def test_teardown_joins_the_gloo_threads():
    """A 1-rank world runs in this process: once `spawn` returns, the
    threads its gloo group started are gone, though the engine it built
    sat in reference cycles."""
    before = _gloo_threads()
    spawn(1, S.engine_rank, 1, device="cpu")
    assert _gloo_threads() == before
