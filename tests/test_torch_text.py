"""paddle_tpu_torch.text against paddle_tpu.text on the CPU: the seven
datasets item for item (every field of every item, exactly: values,
dtypes and shapes) in both modes at a small synthetic size, and each
dataset's lengths, dictionaries and the per-dataset submodules."""
import numpy as np
import pytest

import paddle_tpu.text as jt
import paddle_tpu_torch.text as tt

NAMES = ("Conll05st", "Imdb", "Imikolov", "Movielens", "UCIHousing",
         "WMT14", "WMT16")
KW = {"Imikolov": {"window_size": 4}}


def _make(mod, name, mode, size):
    return getattr(mod, name)(mode=mode, synthetic_size=size,
                              **KW.get(name, {}))


def _fields(item):
    return item if isinstance(item, tuple) else (item,)


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("name", NAMES)
def test_dataset_items_are_the_jax_ones(name, mode):
    got, want = _make(tt, name, mode, 24), _make(jt, name, mode, 24)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        g, w = _fields(got[i]), _fields(want[i])
        assert len(g) == len(w)
        for a, b in zip(g, w):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_full_size_defaults_and_dictionaries():
    c = tt.Conll05st()
    assert len(c) == 512 and len(tt.Conll05st(mode="test")) == 64
    assert len(c[0]) == 9 and all(f.shape == (30,) for f in c[0])
    assert c.word_dict == jt.Conll05st().word_dict
    assert (c.WORD_DICT_LEN, c.PRED_DICT_LEN, c.LABEL_DICT_LEN,
            c.MAX_LEN) == (44068, 3162, 9, 30)
    w = tt.WMT16(mode="test", synthetic_size=4)
    assert w.get_dict("de", reverse=True) == jt.WMT16(
        mode="test", synthetic_size=4).get_dict("de", reverse=True)
    assert len(tt.Imdb(synthetic_size=5).word_idx) == 5149
    seq = tt.Imikolov(data_type="SEQ", synthetic_size=6)
    assert all(np.asarray(s).shape == (30,) for s in seq.data)
    with pytest.raises(ValueError):
        tt.Imikolov(data_type="BAG")
    assert tt.__all__ == jt.__all__
    import paddle_tpu_torch.text.datasets as d
    assert d.conll05.Conll05st is tt.Conll05st
    assert d.wmt16.WMT16 is tt.WMT16
