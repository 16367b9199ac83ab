"""Shared helpers of the PyTorch port's parity tests (``test_torch_*.py``).

The same inputs, made from a seed with numpy (or drawn by JAX and
handed over as numpy), go through the JAX function and its counterpart
in ``realisticaudioraytracing2d_tpu_torch``. Tests that need the card use
the ``cuda_device`` fixture and the ``cuda`` marker: they skip, with a
reason, where ``torch.cuda.is_available()`` is false. Whether a card
exists is decided inside the fixture, never at import time. JAX is
imported only by the helpers that draw JAX's uniforms, so the ``cuda``
tests (tests/test_torch_cuda.py) also run where JAX is not installed.
"""

import time

import numpy as np
import pytest
import torch

# The test suite runs several xdist workers on a few cores.
torch.set_num_threads(1)

cuda = pytest.mark.cuda

# The device every CPU test hands the port's builders: their default is
# the card (realisticaudioraytracing2d_tpu_torch.DEFAULT_DEVICE).
CPU = "cpu"


def to_torch(x, device="cpu") -> torch.Tensor:
    """numpy / JAX array -> torch tensor (a copy, so JAX's read-only
    buffers are never aliased)."""
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def jax_frame_uniforms(key, n_frames: int, max_bounces: int, n_rays: int,
                       device="cpu"):
    """The uniforms JAX's ``engine.trace_accumulate(backend="jnp")`` draws
    for frames ``0..n_frames-1`` of ``key`` (``fold_in(key, f)``), stacked
    as the port's ``(emit[F, R], u[F, B, R, 3])``."""
    from realisticaudioraytracing2d_tpu.ops import rng as jax_rng
    draws = [jax_rng.bounce_uniforms(jax_rng.frame_key(key, f), max_bounces,
                                     n_rays) for f in range(n_frames)]
    return (to_torch(np.stack([np.asarray(e) for e, _ in draws]), device),
            to_torch(np.stack([np.asarray(u) for _, u in draws]), device))


def jax_chunk_uniforms(key, chunk: int, n_frames: int, max_bounces: int,
                       n_rays: int, device="cpu"):
    """The uniforms JAX's ``stream_chunk`` draws for chunk ``chunk``
    (``fold_in(fold_in(key, chunk), frame)``)."""
    from realisticaudioraytracing2d_tpu.ops import rng as jax_rng
    return jax_frame_uniforms(jax_rng.frame_key(key, chunk), n_frames,
                              max_bounces, n_rays, device)


def jax_room_uniforms(key, n_rooms: int, n_frames: int, max_bounces: int,
                      n_rays: int, room_offset: int = 0, device="cpu"):
    """The uniforms JAX's ``sweep_rooms(backend="jnp")`` and the rooms
    kernel's interpret fallback draw for rooms ``room_offset + i``
    (``fold_in(fold_in(key, room), frame)``), stacked as the port's
    ``(emit[E, F, R], u[E, F, B, R, 3])``."""
    import jax
    per_room = [jax_frame_uniforms(jax.random.fold_in(key, room_offset + i),
                                   n_frames, max_bounces, n_rays, device)
                for i in range(n_rooms)]
    return (torch.stack([e for e, _ in per_room]),
            torch.stack([u for _, u in per_room]))


def jax_source_uniforms(key, n_sources: int, max_bounces: int, n_rays: int,
                        device="cpu"):
    """The uniforms JAX's ``trace_sources_mixdown(backend="jnp")`` draws
    (one frame per source under ``jax.random.split(key, S)``), as the
    port's ``(emit[S, 1, R], u[S, 1, B, R, 3])``."""
    import jax
    from realisticaudioraytracing2d_tpu.ops import rng as jax_rng
    draws = [jax_rng.bounce_uniforms(k, max_bounces, n_rays)
             for k in jax.random.split(key, n_sources)]
    return (to_torch(np.stack([np.asarray(e) for e, _ in draws]),
                     device)[:, None],
            to_torch(np.stack([np.asarray(u) for _, u in draws]),
                     device)[:, None])


def jax_shard_ray_uniforms(key, n_shards: int, max_bounces: int,
                           local_rays: int, device="cpu"):
    """The uniforms JAX's ``trace_rays_sharded(backend="jnp")`` draws on
    shard ``d`` (``bounce_uniforms(fold_in(key, d))`` at ``n_rays /
    n_shards`` rays), one ``(emit[R_d], u[B, R_d, 3])`` per shard."""
    import jax
    from realisticaudioraytracing2d_tpu.ops import rng as jax_rng
    draws = [jax_rng.bounce_uniforms(jax.random.fold_in(key, d), max_bounces,
                                     local_rays) for d in range(n_shards)]
    return [(to_torch(np.asarray(e), device), to_torch(np.asarray(u), device))
            for e, u in draws]


def jax_sharded_source_uniforms(key, n_shards: int, n_sources: int,
                                max_bounces: int, n_rays: int, device="cpu"):
    """The uniforms JAX's ``trace_sources_mixdown_sharded(backend="jnp")``
    draws: shard ``d`` splits ``split(key, n_shards)[d]`` among its
    ``n_sources / n_shards`` sources. Stacked in source order as the
    port's ``(emit[S, 1, R], u[S, 1, B, R, 3])``."""
    import jax
    parts = [jax_source_uniforms(k, n_sources // n_shards, max_bounces,
                                 n_rays, device)
             for k in jax.random.split(key, n_shards)]
    return (torch.cat([e for e, _ in parts]), torch.cat([u for _, u in parts]))


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel tests run on the card: "
                    "python -m pytest tests/test_torch_cuda.py -m cuda "
                    "--noconftest)")
    return torch.device("cuda")


def profiler_lead_in(n: int = 64) -> None:
    """Open a profiled window on the card with 50 ms of host time and
    ``n`` short spin kernels (``torch.cuda._sleep``, device name
    ``spin_kernel``). Late in a long process (after the cold-build live
    test, which loads a second copy of the kernel library) the profiler
    drops the device events of the first launches of a session (a K4
    call's first three, or all of them, on an H100); the lead-in takes
    the loss, so the window's own kernels are all recorded. Leave out
    ``spin_kernel`` when counting them."""
    torch.cuda.synchronize()
    time.sleep(0.05)
    for _ in range(n):
        torch.cuda._sleep(1000)


__all__ = ["CPU", "cuda", "cuda_device", "jax_chunk_uniforms",
           "jax_frame_uniforms", "jax_room_uniforms", "jax_shard_ray_uniforms",
           "jax_sharded_source_uniforms", "jax_source_uniforms",
           "profiler_lead_in", "to_numpy", "to_torch"]
