"""The one traffic generator: deterministic from its seed, the same mix
under every seed (the seed changes the order), and conversations that fit
the context."""

import numpy as np
import pytest
import torch

from portbench import traffic as T
from portbench.tests import tiny

torch.set_num_threads(1)


def _lens(script):
    return [[(len(t.prompt), t.max_new, t.greedy, t.doc) for t in c]
            for c in script.clients]


@pytest.mark.parametrize("mix", [tiny.tiny_docqa(), tiny.tiny_chat()])
def test_same_seed_same_script(mix):
    a = T.make_script(mix, 2**33 + 11, 512, 512, 8)
    b = T.make_script(mix, 2**33 + 11, 512, 512, 8)
    c = T.make_script(mix, 2**33 + 12, 512, 512, 8)
    assert [[t.prompt for t in cl] for cl in a.clients] == \
        [[t.prompt for t in cl] for cl in b.clients]
    assert _lens(a) == _lens(b)
    assert [[t.prompt for t in cl] for cl in a.clients] != \
        [[t.prompt for t in cl] for cl in c.clients]


def test_seed_changes_order_not_mix():
    mix = dict(tiny.tiny_docqa(), clients=16, batch=16)
    rounds = []
    for seed in (1, 2**31 + 5, 2**40):
        s = T.make_script(mix, seed, 512, 512, 8)
        r = [sorted(c[k].doc for c in s.clients) for k in range(3)]
        g = [sum(c[k].greedy for c in s.clients) for k in range(3)]
        o = [sorted(c[k].max_new for c in s.clients) for k in range(1, 3)]
        rounds.append((r, g, o))
    # the same documents in the same counts and the same number of greedy
    # turns in every round; reply lengths within one stratum of each other
    assert rounds[0][0] == rounds[1][0] == rounds[2][0]
    assert rounds[0][1] == rounds[1][1] == rounds[2][1]
    width = (mix["output_tokens"][1] - mix["output_tokens"][0] + 1) / 16
    for a, b in zip(rounds[0][2], rounds[1][2]):
        assert np.abs(np.array(a) - np.array(b)).max() <= width + 1


def test_stratified_and_zipf():
    rng = np.random.default_rng(0)
    v = np.sort(T.stratified(rng, 10, 100, 199))
    assert all(100 + 10 * i <= x < 110 + 10 * i for i, x in enumerate(v))
    c = T.zipf_counts(64, 16, 1.0)
    assert c.sum() == 64 and c[0] == max(c) and list(c) == sorted(c)[::-1]
    inv = T.residual_inv(128, 512)
    u = inv(np.linspace(0, 0.999, 1000))
    assert u.min() >= 2 and u.max() <= 512
    # remaining lengths are shorter than whole ones on average
    assert u.mean() < (128 + 512) / 2


def test_documents_fixed_and_shared():
    mix = tiny.tiny_docqa()
    a = T.make_script(mix, 5, 512, 512, 8)
    b = T.make_script(mix, 6, 512, 512, 8)
    la = {t.doc: len(t.prompt) - 0 for c in a.clients for t in c}
    assert set(la) <= set(range(mix["shared_prefix"]["count"]))
    lens_a = T._doc_lengths(3, 70, 140)
    assert list(lens_a) == list(T._doc_lengths(3, 70, 140))
    # every turn on one document starts with the same tokens
    for s in (a, b):
        docs = {}
        for c in s.clients:
            for t in c:
                head = tuple(t.prompt[:lens_a[t.doc]])
                assert docs.setdefault(t.doc, head) == head


def test_conversations_fit_the_context():
    mix = dict(tiny.tiny_chat(), rounds=30)
    s = T.make_script(mix, 9, 512, 512, 8)
    for c in s.clients:
        ctx = 0
        assert c[0].new_session
        for t in c:
            if t.new_session:
                ctx = 0
            assert ctx + len(t.prompt) + t.max_new + 8 + 1 <= 512
            ctx += len(t.prompt) + t.max_new - 1
        assert sum(t.new_session for t in c) >= 2   # conversations restart


def test_open_loop_arrivals():
    mix = dict(tiny.tiny_chat(), loop="open", sessions_per_s=2.0, clients=40)
    a = T.make_script(mix, 3, 512, 512, 8).arrivals
    assert a == T.make_script(mix, 3, 512, 512, 8).arrivals
    assert all(x < y for x, y in zip(a, a[1:]))
    # every seed offers a window the same number of sessions, to within one
    for seed in (4, 2**31 + 9, 2**40):
        b = T.make_script(mix, seed, 512, 512, 8).arrivals
        assert a != b
        for w0 in (0.3, 1.7, 2.2):
            n_a = sum(w0 <= x < w0 + 3.0 for x in a)
            n_b = sum(w0 <= x < w0 + 3.0 for x in b)
            assert abs(n_a - n_b) <= 1 and abs(n_a - 6) <= 1


def test_closed_loop_image_conversations_are_staggered():
    """`session.turns` in a closed loop: each conversation is that many
    turns and starts with an image; client c's first one is cut to
    turns - c % turns, so that every round after the first starts the
    same number of conversations, whatever the seed."""
    mix = dict(tiny.tiny_images(), clients=8, rounds=12)
    for seed in (5, 2**33 + 1):
        s = T.make_script(mix, seed, 512, 1536, 8)
        starts = [[t.index for t in c if t.new_session] for c in s.clients]
        for c, st in enumerate(starts):
            first = 3 - c % 3
            assert st == [0] + list(range(first, 12, 3))
        for c in s.clients:
            assert all((t.image is not None) == t.new_session for t in c)
        per_round = [sum(r in st for st in starts) for r in range(1, 12)]
        assert max(per_round) - min(per_round) <= 1
    assert T.make_script(mix, 5, 512, 1536, 8).clients[2][3].image == \
        T.make_script(mix, 5, 512, 1536, 8).clients[2][3].image
