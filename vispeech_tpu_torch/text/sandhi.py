"""Mandarin tone sandhi.

Implements the standard Mandarin sandhi processes applied word-by-word over a
jieba POS segmentation, with the same behavioral contract as the reference's
PaddleSpeech-derived ToneSandhi (reference text/frontend/tone_sandhi.py:22-348):

  * neutral-tone (轻声) rules: reduplications, sentence-final particles,
    的/地/得, aspect particles 了着过, suffixes 们/子, locatives 上/下/里,
    directional 来/去, classifier 个, plus a lexicalized neutral-tone word list
  * 不 sandhi: bù → bú before tone 4; neutral inside X不X
  * 一 sandhi: yī → yí before tone 4, yì otherwise; neutral in X一X;
    ordinal 第一 and digit strings keep tone 1
  * third-tone sandhi (3 3 → 2 3) with jieba-based word splitting
  * pre-merge passes that re-glue jieba segments (不/一/reduplication/
    consecutive-third-tone/儿) so the rules see whole prosodic words

Tones are carried as the trailing digit of each final (e.g. ``ia1``).

The port's copy of ``vispeech_tpu/text/sandhi.py``: the same behaviour, kept
in step with it by ``tests/test_torch_text.py``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

Seg = Tuple[str, str]  # (word, jieba POS)

# Lexicalized neutral-tone words (linguistic data shared with the reference's
# inventory so outputs match; tone_sandhi.py:24-64).
MUST_NEURAL_TONE_WORDS = {
    '麻烦', '麻利', '鸳鸯', '高粱', '骨头', '骆驼', '马虎', '首饰', '馒头', '馄饨', '风筝',
    '难为', '队伍', '阔气', '闺女', '门道', '锄头', '铺盖', '铃铛', '铁匠', '钥匙', '里脊',
    '里头', '部分', '那么', '道士', '造化', '迷糊', '连累', '这么', '这个', '运气', '过去',
    '软和', '转悠', '踏实', '跳蚤', '跟头', '趔趄', '财主', '豆腐', '讲究', '记性', '记号',
    '认识', '规矩', '见识', '裁缝', '补丁', '衣裳', '衣服', '衙门', '街坊', '行李', '行当',
    '蛤蟆', '蘑菇', '薄荷', '葫芦', '葡萄', '萝卜', '荸荠', '苗条', '苗头', '苍蝇', '芝麻',
    '舒服', '舒坦', '舌头', '自在', '膏药', '脾气', '脑袋', '脊梁', '能耐', '胳膊', '胭脂',
    '胡萝', '胡琴', '胡同', '聪明', '耽误', '耽搁', '耷拉', '耳朵', '老爷', '老实', '老婆',
    '老头', '老太', '翻腾', '罗嗦', '罐头', '编辑', '结实', '红火', '累赘', '糨糊', '糊涂',
    '精神', '粮食', '簸箕', '篱笆', '算计', '算盘', '答应', '笤帚', '笑语', '笑话', '窟窿',
    '窝囊', '窗户', '稳当', '稀罕', '称呼', '秧歌', '秀气', '秀才', '福气', '祖宗', '砚台',
    '码头', '石榴', '石头', '石匠', '知识', '眼睛', '眯缝', '眨巴', '眉毛', '相声', '盘算',
    '白净', '痢疾', '痛快', '疟疾', '疙瘩', '疏忽', '畜生', '生意', '甘蔗', '琵琶', '琢磨',
    '琉璃', '玻璃', '玫瑰', '玄乎', '狐狸', '状元', '特务', '牲口', '牙碜', '牌楼', '爽快',
    '爱人', '热闹', '烧饼', '烟筒', '烂糊', '点心', '炊帚', '灯笼', '火候', '漂亮', '滑溜',
    '溜达', '温和', '清楚', '消息', '浪头', '活泼', '比方', '正经', '欺负', '模糊', '槟榔',
    '棺材', '棒槌', '棉花', '核桃', '栅栏', '柴火', '架势', '枕头', '枇杷', '机灵', '本事',
    '木头', '木匠', '朋友', '月饼', '月亮', '暖和', '明白', '时候', '新鲜', '故事', '收拾',
    '收成', '提防', '挖苦', '挑剔', '指甲', '指头', '拾掇', '拳头', '拨弄', '招牌', '招呼',
    '抬举', '护士', '折腾', '扫帚', '打量', '打算', '打点', '打扮', '打听', '打发', '扎实',
    '扁担', '戒指', '懒得', '意识', '意思', '情形', '悟性', '怪物', '思量', '怎么', '念头',
    '念叨', '快活', '忙活', '志气', '心思', '得罪', '张罗', '弟兄', '开通', '应酬', '庄稼',
    '干事', '帮手', '帐篷', '希罕', '师父', '师傅', '巴结', '巴掌', '差事', '工夫', '岁数',
    '屁股', '尾巴', '少爷', '小气', '小伙', '将就', '对头', '对付', '寡妇', '家伙', '客气',
    '实在', '官司', '学问', '学生', '字号', '嫁妆', '媳妇', '媒人', '婆家', '娘家', '委屈',
    '姑娘', '姐夫', '妯娌', '妥当', '妖精', '奴才', '女婿', '头发', '太阳', '大爷', '大方',
    '大意', '大夫', '多少', '多么', '外甥', '壮实', '地道', '地方', '在乎', '困难', '嘴巴',
    '嘱咐', '嘟囔', '嘀咕', '喜欢', '喇嘛', '喇叭', '商量', '唾沫', '哑巴', '哈欠', '哆嗦',
    '咳嗽', '和尚', '告诉', '告示', '含糊', '吓唬', '后头', '名字', '名堂', '合同', '吆喝',
    '叫唤', '口袋', '厚道', '厉害', '千斤', '包袱', '包涵', '匀称', '勤快', '动静', '动弹',
    '功夫', '力气', '前头', '刺猬', '刺激', '别扭', '利落', '利索', '利害', '分析', '出息',
    '凑合', '凉快', '冷战', '冤枉', '冒失', '养活', '关系', '先生', '兄弟', '便宜', '使唤',
    '佩服', '作坊', '体面', '位置', '似的', '伙计', '休息', '什么', '人家', '亲戚', '亲家',
    '交情', '云彩', '事情', '买卖', '主意', '丫头', '丧气', '两口', '东西', '东家', '世故',
    '不由', '不在', '下水', '下巴', '上头', '上司', '丈夫', '丈人', '一辈', '那个', '菩萨',
    '父亲', '母亲', '咕噜', '邋遢', '费用', '冤家', '甜头', '介绍', '荒唐', '大人', '泥鳅',
    '幸福', '熟悉', '计划', '扑腾', '蜡烛', '姥爷', '照顾', '喉咙', '吉他', '弄堂', '蚂蚱',
    '凤凰', '拖沓', '寒碜', '糟蹋', '倒腾', '报复', '逻辑', '盘缠', '喽啰', '牢骚', '咖喱',
    '扫把', '惦记',
}

MUST_NOT_NEURAL_TONE_WORDS = {
    "男子", "女子", "分子", "原子", "量子", "莲子", "石子", "瓜子", "电子", "人人", "虎虎",
}

_PUNC = "：，；。？！“”‘’':,;.?!"
_PARTICLES = "吧呢哈啊呐噻嘛吖嗨呐哦哒额滴哩哟喽啰耶喔诶"
_DIRECTION_HEADS = "上下进出回过起开"


def _set_tone(final: str, tone: str) -> str:
    return final[:-1] + tone


def _all_tone_three(finals: Sequence[str]) -> bool:
    return all(f[-1] == "3" for f in finals)


def _is_reduplication(word: str) -> bool:
    return len(word) == 2 and word[0] == word[1]


def _split_word(word: str) -> List[str]:
    """Binary prosodic split of a word via jieba's search-mode sub-words."""
    import jieba

    pieces = sorted(jieba.cut_for_search(word), key=len)
    first = pieces[0]
    idx = word.find(first)
    if idx == 0:
        return [first, word[len(first):]]
    return [word[: -len(first)], first]


class ToneSandhi:
    """Word-level sandhi; apply via :meth:`modified_tone` after G2P."""

    # ------------------------------------------------------------------
    # Individual processes
    # ------------------------------------------------------------------

    def _neural_sandhi(self, word: str, pos: str, finals: List[str]) -> List[str]:
        for j in range(1, len(word)):
            if (
                word[j] == word[j - 1]
                and pos[:1] in ("n", "v", "a")
                and word not in MUST_NOT_NEURAL_TONE_WORDS
            ):
                finals[j] = _set_tone(finals[j], "5")
        ge_idx = word.find("个")
        if word and word[-1] in _PARTICLES:
            finals[-1] = _set_tone(finals[-1], "5")
        elif word and word[-1] in "的地得":
            finals[-1] = _set_tone(finals[-1], "5")
        elif len(word) == 1 and word in "了着过" and pos in ("ul", "uz", "ug"):
            finals[-1] = _set_tone(finals[-1], "5")
        elif (
            len(word) > 1
            and word[-1] in "们子"
            and pos in ("r", "n")
            and word not in MUST_NOT_NEURAL_TONE_WORDS
        ):
            finals[-1] = _set_tone(finals[-1], "5")
        elif len(word) > 1 and word[-1] in "上下里" and pos in ("s", "l", "f"):
            finals[-1] = _set_tone(finals[-1], "5")
        elif len(word) > 1 and word[-1] in "来去" and word[-2] in _DIRECTION_HEADS:
            finals[-1] = _set_tone(finals[-1], "5")
        elif (
            ge_idx >= 1
            and (word[ge_idx - 1].isnumeric() or word[ge_idx - 1] in "几有两半多各整每做是")
        ) or word == "个":
            finals[ge_idx] = _set_tone(finals[ge_idx], "5")
        elif word in MUST_NEURAL_TONE_WORDS or word[-2:] in MUST_NEURAL_TONE_WORDS:
            finals[-1] = _set_tone(finals[-1], "5")

        # lexical neutral tone inside compounds
        left, right = _split_word(word)
        parts = [finals[: len(left)], finals[len(left):]]
        for i, sub in enumerate((left, right)):
            if parts[i] and (sub in MUST_NEURAL_TONE_WORDS or sub[-2:] in MUST_NEURAL_TONE_WORDS):
                parts[i][-1] = _set_tone(parts[i][-1], "5")
        return parts[0] + parts[1]

    def _bu_sandhi(self, word: str, finals: List[str]) -> List[str]:
        if len(word) == 3 and word[1] == "不":
            finals[1] = _set_tone(finals[1], "5")
        else:
            for i, char in enumerate(word):
                if char == "不" and i + 1 < len(word) and finals[i + 1][-1] == "4":
                    finals[i] = _set_tone(finals[i], "2")
        return finals

    def _yi_sandhi(self, word: str, finals: List[str]) -> List[str]:
        if "一" in word and all(c.isnumeric() for c in word if c != "一"):
            return finals
        if len(word) == 3 and word[1] == "一" and word[0] == word[-1]:
            finals[1] = _set_tone(finals[1], "5")
        elif word.startswith("第一"):
            finals[1] = _set_tone(finals[1], "1")
        else:
            for i, char in enumerate(word):
                if char == "一" and i + 1 < len(word):
                    if finals[i + 1][-1] == "4":
                        finals[i] = _set_tone(finals[i], "2")
                    elif word[i + 1] not in _PUNC:
                        finals[i] = _set_tone(finals[i], "4")
        return finals

    def _three_sandhi(self, word: str, finals: List[str]) -> List[str]:
        if len(word) == 2 and _all_tone_three(finals):
            finals[0] = _set_tone(finals[0], "2")
        elif len(word) == 3:
            parts = _split_word(word)
            if _all_tone_three(finals):
                if len(parts[0]) == 2:  # disyllabic + monosyllabic (蒙古/包)
                    finals[0] = _set_tone(finals[0], "2")
                    finals[1] = _set_tone(finals[1], "2")
                elif len(parts[0]) == 1:  # monosyllabic + disyllabic (纸/老虎)
                    finals[1] = _set_tone(finals[1], "2")
            else:
                chunks = [finals[: len(parts[0])], finals[len(parts[0]):]]
                for i, sub in enumerate(chunks):
                    if _all_tone_three(sub) and len(sub) == 2:
                        chunks[i][0] = _set_tone(chunks[i][0], "2")
                    elif (
                        i == 1
                        and not _all_tone_three(sub)
                        and chunks[i][0][-1] == "3"
                        and chunks[0][-1][-1] == "3"
                    ):
                        chunks[0][-1] = _set_tone(chunks[0][-1], "2")
                finals = chunks[0] + chunks[1]
        elif len(word) == 4:  # idioms: two disyllabic halves
            out: List[str] = []
            for sub in (finals[:2], finals[2:]):
                if _all_tone_three(sub):
                    sub[0] = _set_tone(sub[0], "2")
                out += sub
            finals = out
        return finals

    # ------------------------------------------------------------------
    # Segment pre-merging
    # ------------------------------------------------------------------

    # injectable word→finals hook: zh_g2p.set_g2p_backend points this at
    # the active alternate backend so segment pre-merging consults the SAME
    # G2P the phones come from (None = pypinyin, the reference default)
    finals_fn = None

    def _word_finals(self, word: str) -> List[str]:
        if ToneSandhi.finals_fn is not None:
            return ToneSandhi.finals_fn(word)
        from pypinyin import Style, lazy_pinyin

        return lazy_pinyin(word, neutral_tone_with_five=True, style=Style.FINALS_TONE3)

    def _merge_bu(self, seg: List[Seg]) -> List[Seg]:
        out: List[Seg] = []
        last = ""
        for word, pos in seg:
            if last == "不":
                word = last + word
            if word != "不":
                out.append((word, pos))
            last = word
        if last == "不":
            out.append((last, "d"))
        return out

    def _merge_yi(self, seg: List[Seg]) -> List[Seg]:
        out: List[List[str]] = []
        # X 一 X reduplication
        for i, (word, pos) in enumerate(seg):
            if (
                i >= 1
                and word == "一"
                and i + 1 < len(seg)
                and seg[i - 1][0] == seg[i + 1][0]
                and seg[i - 1][1] == "v"
            ):
                out[-1][0] = out[-1][0] + "一" + out[-1][0]
            elif i >= 2 and seg[i - 1][0] == "一" and seg[i - 2][0] == word and pos == "v":
                continue
            else:
                out.append([word, pos])
        merged: List[List[str]] = []
        for word, pos in out:
            if merged and merged[-1][0] == "一":
                merged[-1][0] += word
            else:
                merged.append([word, pos])
        return [(w, p) for w, p in merged]

    def _merge_reduplication(self, seg: List[Seg]) -> List[Seg]:
        out: List[List[str]] = []
        for word, pos in seg:
            if out and word == out[-1][0]:
                out[-1][0] += word
            else:
                out.append([word, pos])
        return [(w, p) for w, p in out]

    def _merge_three_tones(self, seg: List[Seg], whole_word: bool) -> List[Seg]:
        finals_list = [self._word_finals(w) for w, _ in seg]
        out: List[List[str]] = []
        merged_prev = [False] * len(seg)
        for i, (word, pos) in enumerate(seg):
            if i >= 1 and not merged_prev[i - 1] and finals_list[i - 1] and finals_list[i]:
                if whole_word:
                    adjacent3 = _all_tone_three(finals_list[i - 1]) and _all_tone_three(
                        finals_list[i]
                    )
                else:
                    adjacent3 = (
                        finals_list[i - 1][-1][-1] == "3" and finals_list[i][0][-1] == "3"
                    )
            else:
                adjacent3 = False
            if adjacent3 and not _is_reduplication(seg[i - 1][0]) and len(
                seg[i - 1][0]
            ) + len(word) <= 3:
                out[-1][0] += word
                merged_prev[i] = True
            else:
                out.append([word, pos])
        return [(w, p) for w, p in out]

    def _merge_er(self, seg: List[Seg]) -> List[Seg]:
        out: List[List[str]] = []
        for i, (word, pos) in enumerate(seg):
            if i >= 1 and word == "儿" and seg[i - 1][0] != "#":
                out[-1][0] += word
            else:
                out.append([word, pos])
        return [(w, p) for w, p in out]

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def pre_merge_for_modify(self, seg: List[Seg]) -> List[Seg]:
        seg = self._merge_bu(seg)
        seg = self._merge_yi(seg)
        seg = self._merge_reduplication(seg)
        seg = self._merge_three_tones(seg, whole_word=True)
        seg = self._merge_three_tones(seg, whole_word=False)
        seg = self._merge_er(seg)
        return seg

    def modified_tone(self, word: str, pos: str, finals: List[str]) -> List[str]:
        finals = self._bu_sandhi(word, finals)
        finals = self._yi_sandhi(word, finals)
        finals = self._neural_sandhi(word, pos, finals)
        finals = self._three_sandhi(word, finals)
        return finals
