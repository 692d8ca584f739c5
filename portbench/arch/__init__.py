"""Architectures, one file each: ``portbench/arch/<name>.py``, found by the
name a configuration file gives under ``architecture`` (``mat`` where it
gives none; ``spec.arch_of``).  Everything the harness knows of a model
is behind that file; the rest of the harness names no leaf, width key or
kernel route.  An architecture file provides:

Model side (the plain reference, ``portbench/reference/<name>.py``):
  ``model_spec(config, modality, task, classes, with_aux)``: one dataset's
  model (an architecture without aux refuses ``with_aux``);
  ``layout(spec)``: every leaf as (path, shape, init kind);
  ``forward(spec, params, inputs, products, feat_out=False)``: inputs and
  outputs by slot (0 image, 1 text); ``preprocess(spec, images)``: uint8
  images as the image slot takes them; the loss heads
  ``cross_entropy(logits, targets)`` and ``contrastive(img, txt)``;
  ``data_shapes(config)``: ``pixels``, ``vocab`` and ``text_len`` of the
  inputs the benchmark makes.

Federation side: ``shared_leaf(path)``, a leaf ``--shared_param attn``
averages across modalities; ``exchanged(path)``, a leaf the aggregation
leaves to the aux exchange; ``has_aux(spec)``; ``exchange_aux(spec, tree,
src_spec, src_tree)``; ``fold_aux(spec, params)``, a client's upload;
``parts(path, tensor)``, the parameters a leaf holds, as the comparison
of each parameter's change counts them.

Weights (``inputs.make_weights``): ``copy_of(tree, path)``, the tensor a
``copy`` leaf starts as; optionally ``DRAWN``, init kinds beyond
``normal`` and ``one``: ``{kind: f(normals) -> tensor}``, each given its
leaf's share of the one generator stream.

Counts: ``tokens(config, tower)``; ``forward_flops(config, tower,
classes)``, one tower's forward over one sequence, every layer by its own
kind; ``layers(config, tower)``: ``[(count, layer)]``, the layer kinds
of a tower and how many of each; ``routes()``: ``{name: Route}``.

Program side (names and values only; ``program.py`` alone imports the
program): ``program_flags(config)``, the model's flags on the program's
command line; ``program_check(config)``, the attributes, with their
values, the program's model configuration must have.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple


class Route(NamedTuple):
    """A kernel route: the ``fc_*`` ranges its calls run under on the
    device timeline, and ``least(rows, n, N, layer, training)``, the least
    seconds of one layer's calls over ``rows`` valid sequences of length
    ``N`` of ``n`` stacked clients (``counts/kernels.py``,
    ``counts/peaks.py``)."""
    ranges: Tuple[str, ...]
    least: Callable[..., float]
