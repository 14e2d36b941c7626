"""Real-valued pytree encoding for jit-boundary I/O.

Framework rule: every jit boundary (donated state pytrees, inputs,
outputs) carries only float32 / int32 leaves; complex math lives
*inside* jit.

``encode``/``decode`` are mechanical and inverse:
- complex64/128  <-> float32 with a trailing [..., 2] re/im axis
- uint32         <-> int32 (bitcast, value-preserving mod 2^32)
- bool/int8/16/uint8/16 <-> int32 (cast)
- float32        unchanged

``decode`` needs the original dtypes; take them from ``spec`` — a pytree
of ``jax.ShapeDtypeStruct`` from ``jax.eval_shape`` (never executed, so
building a spec allocates no unsafe device buffers).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_SMALL_INTS = tuple(np.dtype(d) for d in
                    ("bool", "int8", "int16", "uint8", "uint16"))


def encode(tree):
    """Wire-encode every leaf of a pytree (works under jit and on specs)."""
    def enc(leaf):
        dt = np.dtype(leaf.dtype)
        if dt.kind == "c":
            if isinstance(leaf, jax.ShapeDtypeStruct):
                return jax.ShapeDtypeStruct(leaf.shape + (2,), jnp.float32)
            return jnp.stack([leaf.real, leaf.imag], axis=-1).astype(
                jnp.float32)
        if dt == np.dtype("uint32"):
            if isinstance(leaf, jax.ShapeDtypeStruct):
                return jax.ShapeDtypeStruct(leaf.shape, jnp.int32)
            return jax.lax.bitcast_convert_type(leaf, jnp.int32)
        if dt in _SMALL_INTS:
            if isinstance(leaf, jax.ShapeDtypeStruct):
                return jax.ShapeDtypeStruct(leaf.shape, jnp.int32)
            return leaf.astype(jnp.int32)
        return leaf
    return jax.tree.map(enc, tree)


def decode(tree, spec):
    """Inverse of ``encode``; ``spec`` holds the original ShapeDtypeStructs
    (or arrays) leaf-for-leaf."""
    def dec(leaf, sp):
        dt = np.dtype(sp.dtype)
        if dt.kind == "c":
            return jax.lax.complex(leaf[..., 0], leaf[..., 1]).astype(dt)
        if dt == np.dtype("uint32"):
            return jax.lax.bitcast_convert_type(leaf, jnp.uint32)
        if dt in _SMALL_INTS:
            return leaf.astype(dt)
        return leaf
    return jax.tree.map(dec, tree, spec)


def abstract(fn, *args, **kwargs):
    """jax.eval_shape shorthand: the spec pytree of ``fn(*args)``."""
    return jax.eval_shape(fn, *args, **kwargs)


def zeros(spec):
    """Concrete zeros for a (wire-encoded or plain) spec pytree — used to
    build initial states without ever executing unsafe-dtype eager ops."""
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), spec)
