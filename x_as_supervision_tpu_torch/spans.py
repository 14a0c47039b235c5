"""Named spans of the port's work, recorded by the PyTorch profiler.

``span(name)`` is ``torch.profiler.record_function(name)`` while a profiler
records on this thread (``torch.autograd._profiler_enabled()``; the
autograd engine's threads inherit the caller's profiler) and one shared
no-op context otherwise. An unguarded ``record_function`` costs some 10 us
to enter and leave with nothing recording; the guarded span costs a flag
read, so the hundred-odd spans of a train step cost well under 0.1 ms.
A span records only on a thread the profiler follows: ``torch.profiler.
profile`` follows the thread that starts it and the autograd engine's.

The spans share the device trace's clock: a Chrome trace of
``train_params.profile`` (train/profiling.py) or of any
``torch.profiler.profile`` shows them in Perfetto beside the kernels they
launch. Every name starts with ``xas.``. Those of one train step nest
under ``xas.train.step``, those of one request under ``xas.serve.request``:

  * the train step's phases (train/state.py): preprocess, gen_forward,
    gen_backward, disc_forward, disc_backward, allreduce, optimizer,
    metrics;
  * the modules (models/composed.py): ``xas.model.detector``,
    ``.physique``, ``.discriminator``; the line render
    ``xas.loss.render`` and each loss of the generator
    (``xas.loss.<name>``, the names of its loss dict);
  * ``xas.remat.recompute``: a checkpoint region's recompute, opened on
    the thread that runs the backward (models/remat.py);
  * each kernel op's forward and backward, wrapper included
    (``xas.op.<op>``, ``xas.op.<op>.backward``; ops/);
  * the serve request's stages (serve.py): copy, preprocess, forward,
    fetch, postprocess;
  * the trainer's wait on the loader's queue (``xas.loader.wait``; the
    loader's producer thread is one that the profiler does not follow).
"""

from __future__ import annotations

import contextlib

import torch

TRAIN_STEP = "xas.train.step"
TRAIN_PREPROCESS = "xas.train.preprocess"
GEN_FORWARD = "xas.train.gen_forward"
GEN_BACKWARD = "xas.train.gen_backward"
DISC_FORWARD = "xas.train.disc_forward"
DISC_BACKWARD = "xas.train.disc_backward"
ALLREDUCE = "xas.train.allreduce"
OPTIMIZER = "xas.train.optimizer"
METRICS = "xas.train.metrics"
TRAIN_PHASES = (TRAIN_PREPROCESS, GEN_FORWARD, GEN_BACKWARD, DISC_FORWARD,
                DISC_BACKWARD, ALLREDUCE, OPTIMIZER, METRICS)

DETECTOR = "xas.model.detector"
PHYSIQUE = "xas.model.physique"
DISCRIMINATOR = "xas.model.discriminator"

RENDER = "xas.loss.render"
LOSS_SYMMETRY = "xas.loss.symmetry"
LOSS_SMPL_GEN = "xas.loss.smpl_gen"
LOSS_SMPL_PSEUDO_IMG = "xas.loss.smpl_pseudo_img"
LOSS_PHYSIQUE_RECONS = "xas.loss.physique_recons"
LOSS_RECONSTRUCTION = "xas.loss.reconstruction"

RECOMPUTE = "xas.remat.recompute"

CONV_BN_LINK = "xas.op.conv_bn_link"
CONV3X3 = "xas.op.conv3x3"
INTEGRAL_MARGINALS = "xas.op.integral_marginals"
BACKWARD = ".backward"

SERVE_REQUEST = "xas.serve.request"
SERVE_COPY = "xas.serve.copy"
SERVE_PREPROCESS = "xas.serve.preprocess"
SERVE_FORWARD = "xas.serve.forward"
SERVE_FETCH = "xas.serve.fetch"
SERVE_POSTPROCESS = "xas.serve.postprocess"
SERVE_STAGES = (SERVE_COPY, SERVE_PREPROCESS, SERVE_FORWARD, SERVE_FETCH,
                SERVE_POSTPROCESS)

LOADER_WAIT = "xas.loader.wait"

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records `name` while a profiler records on this
    thread; the one shared no-op context otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
