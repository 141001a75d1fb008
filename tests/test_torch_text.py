"""The port's text frontend held against the JAX package's, on the CPU.

Every case of ``tests/test_text.py`` that runs here goes through both
``vispeech_tpu.text`` and ``vispeech_tpu_torch.text``; each case returns
what it computed (or the exception it expects, as type name and message),
together with what it printed, and the two must be equal.  A hypothesis
test then draws mixed strings of the golden corpus's characters, fenced
and unfenced, and holds both packages to the same phones, or the same
exception type, with the same two lexicons loaded into each.

Both packages keep module-level state (the loaded lexicons and the zh G2P
backend slot); every test saves and restores it in both.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import io
import random
import sys
from types import SimpleNamespace

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import test_text as jax_text_tests

MODULES = ("cleaner", "en_normalization", "frontends", "lexicon", "mix",
           "normalization", "phonetics", "pinyin", "sandhi", "symbols", "t2s_data",
           "zh_g2p")


def _package(root: str) -> SimpleNamespace:
    pkg = importlib.import_module(f"{root}.text")
    mods = {m: importlib.import_module(f"{root}.text.{m}") for m in MODULES}
    return SimpleNamespace(pkg=pkg, **mods)


JAX = _package("vispeech_tpu")
PORT = _package("vispeech_tpu_torch")
PACKAGES = (JAX, PORT)

# the golden corpus's lexicons
ZH_LEX = jax_text_tests.TestGoldenAdversarialCorpus.ZH_LEX
EN_LEX = jax_text_tests.TestGoldenAdversarialCorpus.EN_LEX

GOLDEN = (
    "借还款,他只是一个纸老虎，开户行，奥大家好33啊我是Ab3s,?"
    "萨达撒abst 123、~~、、 但是、、、A B C D!",
    "嗯？什么东西…沉甸甸的…下午1:00，今天是2022/5/10",
    "[P]pin1 yin1 zhen1 hao3 wan2[P]扎堆儿-#",
    "早上好，今天是2020/10/29，最低温度是-3°C。",
)


@contextlib.contextmanager
def _saved_state():
    """Save and restore both packages' lexicons and zh G2P backend."""
    saved = [(P, dict(P.frontends._ZH_LEXICON), P.frontends._ZH_LEX_MAXLEN,
              dict(P.frontends._EN_LEXICON)) for P in PACKAGES]
    try:
        yield
    finally:
        for P, zh, zh_len, en in saved:
            P.frontends._ZH_LEXICON.clear()
            P.frontends._ZH_LEXICON.update(zh)
            P.frontends._ZH_LEX_MAXLEN = zh_len
            P.frontends._EN_LEXICON.clear()
            P.frontends._EN_LEXICON.update(en)
            P.zh_g2p.set_g2p_backend("pypinyin")


@pytest.fixture(autouse=True)
def _restore_state():
    with _saved_state():
        yield


@pytest.fixture(scope="module")
def lexicon_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("lexicons")
    (root / "zh.lex").write_text(ZH_LEX, encoding="utf-8")
    (root / "en.lex").write_text(EN_LEX, encoding="utf-8")
    return str(root / "zh.lex"), str(root / "en.lex")


def _load(P, zh=None, en=None):
    if zh:
        P.frontends.load_zh_lexicon(zh)
    if en:
        P.frontends.load_en_lexicon(en)


def _raises(fn, *args):
    """Call ``fn``; the exception it raises as (type name, message)."""
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 - the type is the result
        return type(e).__name__, str(e)
    raise AssertionError(f"{fn.__name__}{args} did not raise")


def _run(case, P, lexicons):
    """(result, what the case printed) for one package."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = case(P, lexicons)
    return result, out.getvalue()


# ------------------------------------------------------------------ cases
# Each takes (package, (zh lexicon path, en lexicon path)) and returns a
# plain value that must be equal for both packages.

def case_symbols(P, lex):
    s = P.symbols
    return (s.symbols, s.SYMBOL_TO_ID, s.ID_TO_SYMBOL, s.N_SYMBOLS, s.zh_symbols,
            s.ja_symbols, s.en_symbols, s.pu_symbols, sorted(s.symbol_set()),
            P.pkg.symbols, P.pkg.N_SYMBOLS,
            P.pkg.sequence_to_symbols(range(0, s.N_SYMBOLS, 7)))


def case_pinyin(P, lex):
    sylls = list(P.lexicon.generate_lexicon(with_tone=True, with_erhua=True))
    sylls += ["zhuang1", "jun4", "qu2", "lüe4", "nv3", "r5", "m2", "n4", "hm5"]
    parsed = []
    for syl in sylls:
        try:
            parsed.append(P.pinyin.pinyin_syllable_to_phones(syl))
        except ValueError as e:
            parsed.append(str(e))
    return parsed, P.pinyin.pinyin_to_phonemes("blarg9 ni3  zhongr1 huar4 x")


def case_cleaner(P, lex):
    texts = ["[P]pin1 yin1 zhen1 hao3 wan2[P]", "[P]ni3 hao3[P]！", "[P]ni3[P]。",
             "[P]ni3[P]—", "[P]ni3 hao3 shi4 jie4[P]!", "[P]ni3[P]...",
             "[P]ni3[P]【】“”（）%#@&‘\n·～―：；", "[P]ni3 hao3[P]，[P]zai4 jian4[P]？"]
    return ([P.cleaner.text_to_phones(t) for t in texts],
            [P.cleaner.text_to_sequence(t) for t in texts],
            [P.pkg.text_to_sequence(t) for t in texts],
            [P.cleaner.str_replace(t) for t in texts],
            P.cleaner.remove_invalid_phonemes(["a1", "-", "--", "xx", "sp", "AE1"]))


NSW = ["2021年5月4日", "下午1:30", "温度-3°C", "涨了3/4", "百分比50%", "3~5个",
       "13812345678", "全角１２３", "编号00078", "今天是2020/10/29", "2022/5/10",
       "电话010-12345678", "下午1:00", "12:30:45开始", "-3.5度", "共1,234人",
       "第3名", "2020-10-29", "降了5%~10%", "这里有100个苹果。你好，世界！再见"]


def case_normalization(P, lex):
    n = P.normalization
    cardinals = ["0", "000", "15", "105", "1305", "10005", "123456789", "20", "1000000",
                 "1010", "100000001"]
    tn = n.TextNormalizer()
    return ([n.verbalize_cardinal(c) for c in cardinals],
            [n.num2str(x) for x in ("3.20", ".22", "0.5", "12", "7.05")],
            n.verbalize_digits("2021"), n.verbalize_digits("110", alt_one=True),
            [tn.normalize(t) for t in NSW],
            tn.split("你好，世界。再见！"), tn.split("你好，世界。再见！", lang="en"))


def case_zh_lexicon_fallback(P, lex):
    pytest.importorskip("jieba")
    path = lex[0] + ".small"
    with open(path, "w", encoding="utf-8") as f:
        f.write("你好 ni3 hao3\n你 ni3\n好 hao3\n世界 shi4 jie4\n这 zhe4\n是 shi4\n")
    P.frontends.load_zh_lexicon(path)
    return (P.frontends._lexicon_zh_g2p("你好世界"), P.frontends._lexicon_zh_g2p("这是你好,"),
            P.frontends._ZH_LEX_MAXLEN, P.frontends.zh_to_phonemes("你好，世界！"))


def case_zh_lexicon_missing_hanzi(P, lex):
    path = lex[0] + ".one"
    with open(path, "w", encoding="utf-8") as f:
        f.write("你 ni3\n")
    P.frontends.load_zh_lexicon(path)
    return _raises(P.frontends._lexicon_zh_g2p, "你猫")


def case_zh_without_backend(P, lex):
    """No pypinyin and no lexicon: hanzi raise, punctuation passes."""
    return (_raises(P.frontends.zh_to_phonemes, "你好"),
            P.frontends.zh_to_phonemes("，。！…"),
            _raises(P.cleaner.text_to_phones, "[ZH]你好[ZH]"))


def case_zh_without_jieba(P, lex):
    """A loaded lexicon but no jieba: sandhi's word split raises ImportError."""
    _load(P, *lex)
    saved = sys.modules.get("jieba")
    sys.modules["jieba"] = None
    try:
        return (_raises(P.cleaner.text_to_phones, "早上好"),
                _raises(P.cleaner.text_to_phones, "12"),
                P.cleaner.text_to_phones("ab c, d!"))
    finally:
        if saved is None:
            sys.modules.pop("jieba", None)
        else:
            sys.modules["jieba"] = saved


def case_generate_lexicon(P, lex):
    L = P.lexicon
    return ([dict(L.generate_lexicon(with_tone=t, with_erhua=r))
             for t in (False, True) for r in (False, True)],
            dict(L.generate_ja_lexicon()), L.MFA_SPECIALS, L.INITIALS, L.FINALS,
            [L.render_syllable(c, v, r, t) for c in ("", "j", "zh", "b")
             for v in ("i", "ii", "iii", "v", "ve", "uei", "iou", "ong", "er")
             for r in ("", "r") for t in ("", "3")])


def case_en_normalization(P, lex):
    e = P.en_normalization
    rng = random.Random(0)
    sample = list(range(0, 1001)) + [rng.randrange(0, 10 ** 6 + 1) for _ in range(3000)]
    sample += [10 ** 6, 1200000, 3042, 999999]
    texts = ["1,234 things", "4,321 things", "$2.50", "$1", "£5", "3.14", "the 2nd time",
             "in 1999", "in 1905", "in 2000", "in 2005", "in 1900", "$0.01", "$3",
             "1st 22nd 33rd 104th", "10,000,000", "-5 and 7.5%"]
    return ([e.number_to_words(n) for n in sample],
            [e.ordinal_to_words(n) for n in sample[:1200]],
            [e.normalize_numbers(t) for t in texts],
            [e.normalize(t) for t in ("Café, 3 items!", "He said: i.e. now",
                                      "Mr. Smith & Dr. Who, e.g. 5th", "ÀÉÎÕÜ ñ")],
            e.full2half_width("ＡＢＣ　１２３"), e.half2full_width("AB 1"))


def case_en_g2p(P, lex):
    P.frontends._EN_LEXICON.update({"twenty": ["T", "W", "EH1", "N", "T", "IY0"],
                                    "one": ["W", "AH1", "N"]})
    digits = P.frontends.en_to_phonemes("21")
    _load(P, en=lex[1])
    return (digits, P.frontends.en_to_phonemes("Ab c, d! abst-s"),
            _raises(P.frontends.en_to_phonemes, "hello"),
            P.cleaner.text_to_phones("[EN]ab c, d![EN]"),
            P.cleaner.text_to_phones("ab c, d!"))


def case_phonetics(P, lex):
    ph = P.phonetics
    v = ph.Vocab(["a", "b", "a"])
    first = (len(v), v.padding_index, v.unk_index, v.start_index, v.end_index,
             v.lookup("a"), v.reverse(5), v.lookup("MISSING"), repr(v), v.num_specials)
    v.add_symbols(["c", "b"])
    bare = ph.Vocab(["x"], padding_symbol=None, unk_symbol=None, start_symbol=None,
                    end_symbol=None)
    fake = lambda s: ["HH", "AH0", "L", "OW1", " ", "@", "!"]  # noqa: E731
    a, sw = ph.Arpabet(backend=fake), ph.ArpabetWithStress(backend=fake)
    cat = ph.Arpabet(backend=lambda s: ["K", "AE1", "T"])
    phones = cat.phoneticize("cat", add_start_end=True)
    _load(P, en=lex[1])
    default = ph.ArpabetWithStress()
    return (first, v.lookup("c"), len(v), len(bare), bare.num_specials,
            bare.padding_index, _raises(bare.lookup, "missing"),
            len(a.phonemes), a.vocab_size, len(sw.phonemes), sw.vocab_size, a.symbols,
            a.phoneticize("hello!"), sw.phoneticize("hello!"), phones,
            cat.reverse(cat.numericalize(phones)), cat("cat"),
            ph.ARPABET_PHONES, ph.ARPABET_STRESS_PHONES, ph.PUNCTUATIONS,
            default.phoneticize("ab c, d!"), default("abst"))


def _golden(i):
    def case(P, lex):
        pytest.importorskip("jieba")
        _load(P, *lex)
        return P.cleaner.text_to_phones(GOLDEN[i])
    case.__name__ = f"case_golden_{i}"
    return case


def case_polyphone_de_lexicon(P, lex):
    pytest.importorskip("jieba")
    P.frontends._ZH_LEXICON.clear()
    P.frontends._ZH_LEXICON.update({"地": ["di4"], "地方": ["di4", "fang1"]})
    P.frontends._ZH_LEX_MAXLEN = 2
    return (P.frontends._lexicon_zh_g2p("地"), P.frontends._lexicon_zh_g2p("地方"),
            P.frontends._lexicon_zh_g2p("地地方地"), P.frontends._POLYPHONE_SINGLE)


def case_g2p_backend_slot(P, lex):
    z = P.zh_g2p
    split = z.pinyins_to_initials_finals(["zhong1", "shi4", "nu:3", "de", ",", "r5", "x"])
    unknown = _raises(z.set_g2p_backend, "bogus")
    try:
        import g2pM  # noqa: F401
        g2pm = "present"
    except ImportError:
        g2pm = _raises(z.set_g2p_backend, "g2pM")
    return split, unknown, g2pm, z.get_g2p_backend()


def case_injected_backend(P, lex):
    pytest.importorskip("jieba")
    table = {"你": "ni3", "好": "hao3", "世": "shi4", "界": "jie4", "小": "xiao3",
             "老": "lao3", "虎": "hu3", "一": "yi1", "个": "ge4", "不": "bu4",
             "是": "shi4", "儿": "er2", "花": "hua1"}

    def fake_neural_g2p(word):
        return [table[ch] for ch in word]

    z = P.zh_g2p
    z.set_g2p_backend(fake_neural_g2p)
    return (z.get_g2p_backend(), z.sentence_to_phonemes("你好世界"),
            z.sentence_to_phonemes("小老虎不是一个花儿", with_erhua=True),
            z.hanzi_to_phonemes("你好世界"))


def case_t2s(P, lex):
    n = P.normalization
    t = P.t2s_data
    return (n._traditional_to_simplified("這是繁體中文測試"),
            n._traditional_to_simplified("溫度計顯示零下三度"),
            n._traditional_to_simplified("abc 你好123"),
            n.TextNormalizer().normalize("這裡有100個蘋果"),
            t.TRADITIONAL, t.SIMPLIFIED, t.T2S)


def case_mix_segments(P, lex):
    texts = ["你好abc世界", "abcあいう", "…abc", "ｱｲ123,d", "Ab3s,?萨达撒abst 123",
             "：；，。！？【】“（）%#@&‘\n”—·、", ""]
    return [P.mix.get_segments(t) for t in texts]


CASES = [case_symbols, case_pinyin, case_cleaner, case_normalization,
         case_zh_lexicon_fallback, case_zh_lexicon_missing_hanzi, case_zh_without_backend,
         case_zh_without_jieba, case_generate_lexicon, case_en_normalization, case_en_g2p,
         case_phonetics, *(_golden(i) for i in range(len(GOLDEN))),
         case_polyphone_de_lexicon, case_g2p_backend_slot, case_injected_backend,
         case_t2s, case_mix_segments]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_port_matches_jax(case, lexicon_files):
    ref = _run(case, JAX, lexicon_files)
    with _saved_state():
        ours = _run(case, PORT, lexicon_files)
    assert ours == ref


def test_smoke_text_phase_uses_the_golden_corpus(lexicon_files):
    """chip_smoke.py's phase 3f holds the golden corpus's lexicons, and its
    Mandarin string's phones are the port's (so the JAX golden's)."""
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert (smoke.TEXT_ZH_LEX, smoke.TEXT_EN_LEX) == (ZH_LEX, EN_LEX)
    assert smoke.TEXT_GOLDEN_ZH[0] == GOLDEN[3]
    pytest.importorskip("jieba")
    _load(PORT, *lexicon_files)
    assert PORT.pkg.text_to_phones(GOLDEN[3]) == smoke.TEXT_GOLDEN_ZH[1]


# -------------------------------------------------------------- hypothesis

_HANZI = sorted(set("".join(ZH_LEX.split()) + "".join(GOLDEN)) - set(
    "0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ []"))
_ALPHABET = (_HANZI + list("0123456789/:%-°C.") + list("abcdstABCDxyz ")
             + list("あいうかアイウカ") + list("，。！？、：；（）…～—“”"))
_PINYIN = ["ni3", "hao3", "zhuang1", "dianr3", "er2", "lüe4", "xx9", ""]
_WORDS = [line.split()[0] for line in ZH_LEX.splitlines()] + [
    "33", "1:00", "2020/10/29", "-3°C", "，", "。", "…", "ab", "abst "]
_SEGMENT = st.one_of(
    st.tuples(st.sampled_from(["", "ZH", "EN"]),
              st.text(alphabet=_ALPHABET, max_size=10)),
    st.tuples(st.sampled_from(["", "ZH"]),
              st.lists(st.sampled_from(_WORDS), max_size=5).map("".join)),
    st.tuples(st.just("P"), st.lists(st.sampled_from(_PINYIN), max_size=4).map(" ".join)),
)


def _outcome(P, text):
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            return "ok", P.pkg.text_to_phones(text), out.getvalue()
    except Exception as e:  # noqa: BLE001 - the type is the result
        return "raise", type(e).__name__, out.getvalue()


@settings(max_examples=150, deadline=None, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(segments=st.lists(_SEGMENT, min_size=1, max_size=4))
def test_random_mixed_text_matches_jax(segments, lexicon_files):
    pytest.importorskip("jieba")
    text = "".join(f"[{lang}]{body}[{lang}]" if lang else body for lang, body in segments)
    with _saved_state():
        for P in PACKAGES:
            _load(P, *lexicon_files)
        assert _outcome(PORT, text) == _outcome(JAX, text), text
