"""The environment switches of the port's optional paths.

Counterpart of the JAX package's ``ops/dispatch.py``, :func:`kernel_mode`
only.  The port reads two switches:

* ``SICZ_TPU_PALLAS_LSTM`` (default ``auto``), through
  ``models/layers.hoist_lstm_inputs``, as the JAX package's
  ``layers.hoist_lstm_inputs`` does (``models/layers.py:178-190``): under
  ``auto`` and ``off`` the LSTM input hoists are on (BUTD's
  ``td_mean_gates``, every family's ``tf_inputs``), the function of the
  JAX package's default mode; under ``interpret`` they are off and each
  cell takes its whole concat every step, the function of the JAX
  package's ``interpret`` mode.  Int8 cells are never hoisted.  Unlike the
  JAX package's ``off``, no mode takes the cell off its kernel: on the
  card every float cell runs on K2, with the hoisted part as its gate
  term.
* ``SICZ_TPU_INT8_KV`` (default ``off``, as in the JAX package): whether
  encode stores the decoder's hoisted K/V as int8 with per-row scales, so
  that every decode step attends through kernel K4
  (``ops/int8_attention.py``).  In the port ``auto`` and ``interpret``
  mean the same: store int8 K/V wherever ``int8_attention.supported``
  holds.  On a CUDA tensor K4 then launches; on a CPU tensor its plain
  version runs.

So what a path computes depends on the switches and the shapes, never on
the device, and a CPU run and a card run with the same switches compute
the same function.  The JAX package's ``on_tpu`` has no counterpart, and
its kill switches of the other kernels (``SICZ_TPU_PALLAS_QUANT``,
``SICZ_TPU_FUSED_HEAD``) are not read: on the card a kernel wrapper
launches its kernel or raises.
"""
from __future__ import annotations

import os
import warnings

_WARNED: set = set()


def kernel_mode(env_var: str, default: str = "auto") -> str:
    """'auto', 'off' or 'interpret' from ``env_var``.  Values normalize
    case-insensitively; '0', 'false', 'no', 'disable' and 'disabled' mean
    'off'.  Anything else warns once and gives ``default``."""
    raw = os.environ.get(env_var)
    if raw is None:
        return default
    val = raw.strip().lower()
    if val in ("0", "false", "no", "disable", "disabled"):
        return "off"
    if val in ("auto", "off", "interpret"):
        return val
    if (env_var, raw) not in _WARNED:
        _WARNED.add((env_var, raw))
        warnings.warn("%s=%r not recognized (auto|off|interpret); using %r"
                      % (env_var, raw, default))
    return default
