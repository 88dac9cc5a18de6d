"""
The port's text sampling (``lhotse_tpu_torch.cut.text``,
``TokenConstraint`` in ``dataset/sampling/base.py`` and
``lazy.LazyTxtIterator``) against the JAX package, on the cases of
``tests/test_token_constraint_text_sampling.py``: the constraint's answers
and counters step by step, ``DynamicCutSampler`` batches of seeded token
counts, and the text iterator's examples with its resumable position. All
of it is exact: integer bookkeeping and strings.
"""
import gzip

import numpy as np
import pytest

from lhotse_tpu.cut.text import TextExample as JTextExample
from lhotse_tpu.cut.text import TextPairExample as JTextPairExample
from lhotse_tpu.dataset.sampling.base import TokenConstraint as JTokenConstraint
from lhotse_tpu.dataset.sampling.dynamic import DynamicCutSampler as JDynamicCutSampler
from lhotse_tpu.lazy import LazyTxtIterator as JLazyTxtIterator
from lhotse_tpu_torch.cut import TextExample, TextPairExample
from lhotse_tpu_torch.dataset import DynamicCutSampler, TokenConstraint
from lhotse_tpu_torch.lazy import LazyTxtIterator

PORT = (TextExample, TextPairExample, TokenConstraint, DynamicCutSampler, LazyTxtIterator)
JAX = (JTextExample, JTextPairExample, JTokenConstraint, JDynamicCutSampler, JLazyTxtIterator)


def _example(cls, n_tokens: int):
    return cls(text="x " * n_tokens, tokens=np.arange(n_tokens))


def _trace(pkg, kwargs, lengths):
    """The constraint's counters and answers after each added example."""
    example_cls, _, constraint_cls, _, _ = pkg
    c = constraint_cls(**kwargs)
    out = []
    for n in lengths:
        c.add(_example(example_cls, n))
        out.append((c.current, c.num_examples, c.longest_seen, c.exceeded(),
                    c.close_to_exceeding()))
    c.reset()
    out.append((c.current, c.num_examples, c.longest_seen))
    return out


@pytest.mark.parametrize("kwargs,lengths", [
    (dict(max_tokens=100), [40, 10, 30]),  # padded budget: 3 x 40 > 100
    (dict(max_tokens=100), [10, 50, 10]),  # the longest seen governs
    (dict(max_tokens=10_000, max_examples=2), [5, 5, 5]),
    (dict(max_tokens=50), [49, 1]),
    (dict(max_tokens=100, quadratic_length=10), [50]),  # 50 + 50^2/10 > 100
    (dict(max_examples=3), [7, 8, 9, 10]),
], ids=["padded", "longest", "max_examples", "reset", "quadratic", "count_only"])
def test_token_constraint_traces_equal_jax(kwargs, lengths):
    assert _trace(PORT, kwargs, lengths) == _trace(JAX, kwargs, lengths)


def test_token_constraint_semantics():
    """tests/test_token_constraint_text_sampling.py's expectations."""
    c = TokenConstraint(max_tokens=100)
    c.add(_example(TextExample, 40))
    assert not c.close_to_exceeding()
    c.add(_example(TextExample, 10))
    assert not c.exceeded()
    c.add(_example(TextExample, 30))
    assert c.exceeded()
    quad = TokenConstraint(max_tokens=100, quadratic_length=10)
    quad.add(_example(TextExample, 50))
    assert quad.exceeded()
    with pytest.raises(AssertionError):
        TokenConstraint(max_tokens=0)
    with pytest.raises(AssertionError):
        JTokenConstraint(max_tokens=0)


def test_measure_length_and_examples_equal_jax():
    for pkg in (PORT, JAX):
        example_cls, pair_cls, constraint_cls = pkg[:3]
        c = constraint_cls(max_tokens=10)
        assert c.measure_length(_example(example_cls, 7)) == 7
        pair = pair_cls(source=_example(example_cls, 3), target=_example(example_cls, 9))
        assert c.measure_length(pair) == 3 and pair.num_tokens == 3
        assert example_cls("plain").num_tokens is None


class _Eager:
    def __init__(self, examples):
        self.examples = examples

    def __iter__(self):
        return iter(self.examples)

    def __len__(self):
        return len(self.examples)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_tokens", [80, 200])
def test_dynamic_sampler_with_token_constraint_equals_jax(seed, max_tokens):
    lengths = np.random.default_rng(seed).integers(3, 60, size=40)
    batches = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        example_cls, _, constraint_cls, sampler_cls, _ = pkg
        sampler = sampler_cls(
            _Eager([_example(example_cls, int(n)) for n in lengths]),
            constraint=constraint_cls(max_tokens=max_tokens), world_size=1, rank=0,
            shuffle=False)
        batches[name] = [[e.num_tokens for e in b] for b in sampler]
    assert batches["port"] == batches["jax"]
    assert [n for b in batches["port"] for n in b] == list(lengths)
    for b in batches["port"]:
        # The batch closes ON the crossing element, so every proper prefix
        # keeps the budget.
        if len(b) > 1:
            assert len(b[:-1]) * max(b[:-1]) <= max_tokens


@pytest.mark.parametrize("compressed", [False, True])
def test_lazy_txt_iterator_equals_jax_and_resumes(tmp_path, compressed):
    lines = "hello world\nsecond line\n\nthird\n  spaced out  \nlast"
    path = tmp_path / ("corpus.txt.gz" if compressed else "corpus.txt")
    if compressed:
        with gzip.open(path, "wt") as f:
            f.write(lines)
    else:
        path.write_text(lines)
    ours, theirs = LazyTxtIterator(path), JLazyTxtIterator(path)
    got = list(ours)
    assert [e.text for e in got] == [e.text for e in list(theirs)]
    assert all(isinstance(e, TextExample) and e.num_tokens is None for e in got)
    assert len(ours) == len(theirs)
    assert [t for t in LazyTxtIterator(path, as_text_example=False)] == [
        t for t in JLazyTxtIterator(path, as_text_example=False)]

    it = iter(ours)
    head = [next(it).text for _ in range(2)]
    state = ours.state_dict()
    assert state == {"position": 2}
    jresumed = JLazyTxtIterator(path)
    jresumed.load_state_dict(dict(state))
    resumed = LazyTxtIterator(path)
    resumed.load_state_dict(state)
    tail = [e.text for e in resumed]
    assert head + tail == [e.text for e in got]
    assert tail == [e.text for e in jresumed]
