"""Stage-isolated timings for the headline bench shape.

Each stage prefix (full step, bank only, bank + discriminator + symbol
filter) is its own jitted program over the same inputs; the difference
between prefixes is a stage's share. Run on the GPU:

    python tools/profile_bench.py [n_sources]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def timeit(fn, state, *args, n=10, threads_state=False):
    """Steady-state ms/call. With ``threads_state`` the fn returns
    (new_state, out) and state is threaded (donation-compatible, like
    the real streaming loop)."""
    import jax

    def call(st):
        r = fn(st, *args)
        return r if threads_state else (st, r)

    state, out = call(state)
    jax.block_until_ready((state, out))
    t0 = time.perf_counter()
    for _ in range(n):
        state, out = call(state)
    jax.block_until_ready((state, out))
    return (time.perf_counter() - t0) / n * 1e3


def main(n_sources=128):
    import jax
    import jax.numpy as jnp
    from radiocapture_tpu.frontend.pipeline import ControlPipeline
    from radiocapture_tpu.ops import fm as _fm
    from radiocapture_tpu.frontend.pipeline import _bank_step, _batched_fir
    from radiocapture_tpu.utils import wire as _wire

    if jax.default_backend() != "gpu":
        sys.exit("profile_bench.py: needs a GPU, found "
                 f"{jax.default_backend()!r}")
    dev = jax.devices()[0]
    samp_rate = 2.4e6
    num_slots = 64
    pipe = ControlPipeline.p25_c4fm(num_slots=num_slots,
                                    samp_rate=samp_rate)
    block = pipe.decim * 2500

    rng = np.random.default_rng(0)
    x = jax.device_put(
        rng.standard_normal((n_sources, block, 2)).astype(np.float32), dev)
    offs = jax.device_put(jnp.asarray(np.tile(
        ((np.arange(num_slots) - num_slots // 2)
         * 25e3 / samp_rate).astype(np.float32), (n_sources, 1))), dev)
    state = jax.device_put(jax.tree.map(
        lambda l: jnp.broadcast_to(l, (n_sources,) + l.shape),
        pipe.init()), dev)

    # donate_argnums matches bench.py: without it the state pytree is
    # double-allocated and the 128-source working set spills HBM.
    full = jax.jit(jax.vmap(pipe._step_impl), donate_argnums=(0,))
    ms = timeit(full, jax.tree.map(jnp.copy, state), x, offs,
                threads_state=True)
    agg = n_sources * block / 1e6
    print(f"full step      : {ms:7.2f} ms  ({agg / ms * 1e3:7.1f} MS/s)")

    def bank_only(wire_state, x, offsets):
        st = _wire.decode(wire_state, pipe._state_spec)
        bs, chans = _bank_step(pipe.bank, st.bank, x, offsets)
        new = st._replace(bank=bs)
        return (_wire.encode(new),
                jnp.stack([jnp.real(chans), jnp.imag(chans)], -1))

    ms_b = timeit(jax.jit(jax.vmap(bank_only), donate_argnums=(0,)),
                  jax.tree.map(jnp.copy, state), x, offs,
                  threads_state=True)
    print(f"bank only      : {ms_b:7.2f} ms")

    def thru_fir(wire_state, x, offsets):
        st = _wire.decode(wire_state, pipe._state_spec)
        bs, chans = _bank_step(pipe.bank, st.bank, x, offsets)
        qs, disc = _fm.quadrature_demod(st.quad, chans, pipe.disc_gain)
        sh, filt = _batched_fir(st.sym_hist, disc, pipe.sym_taps,
                                stride=pipe.sym_decim)
        new = st._replace(bank=bs, quad=qs, sym_hist=sh)
        return _wire.encode(new), filt

    ms_f = timeit(jax.jit(jax.vmap(thru_fir), donate_argnums=(0,)),
                  jax.tree.map(jnp.copy, state), x, offs,
                  threads_state=True)
    print(f"bank+disc+fir  : {ms_f:7.2f} ms")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 128)
