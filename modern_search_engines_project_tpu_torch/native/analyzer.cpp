// Native text analyzer: tokenize + normalize + stopword filter + lemma-light.
//
// C++ fast path for the corpus analysis pipeline (the role spaCy/Cython
// plays in the reference, bm25_indexer.py:16-54).  Behavior is bit-identical
// to the Python implementation in text/analyzer.py on Latin-1 text; beyond
// it, lower_cp folds case for fewer code points than str.lower(), and this
// route is the default (Analyzer(), HashTokenizer()).
// tests/test_torch_text_native.py holds both routes against the reference
// package's.
//
// Exposed via a minimal C ABI for ctypes (no pybind11 in the image):
//   msetpu_analyze(text, len) -> newline-joined tokens (caller frees with
//   msetpu_free).
//
// Built by native/native_analyzer.py at first use:
//   g++ -O2 -std=c++17 -shared -fPIC -o libmse_analyzer.so analyzer.cpp

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr size_t MAX_DOC_CHARS = 1000000;  // bm25_indexer.py:33 analog

// ---- codepoint classification ------------------------------------------

// letters accepted by the token pattern (analyzer.py _TOKEN_RE)
bool is_token_cp(uint32_t cp) {
  if ((cp >= 'a' && cp <= 'z') || (cp >= 'A' && cp <= 'Z')) return true;
  switch (cp) {
    case 0x00E4: case 0x00F6: case 0x00FC:               // ä ö ü
    case 0x00C4: case 0x00D6: case 0x00DC:               // Ä Ö Ü
    case 0x00DF:                                         // ß
    case 0x00E0: case 0x00E2: case 0x00E9: case 0x00E8:  // à â é è
    case 0x00EA: case 0x00EB: case 0x00ED: case 0x00EC:  // ê ë í ì
    case 0x00EE: case 0x00EF: case 0x00F3: case 0x00F2:  // î ï ó ò
    case 0x00F4: case 0x00FA: case 0x00F9: case 0x00FB:  // ô ú ù û
    case 0x00F1: case 0x00E7:                            // ñ ç
      return true;
    default:
      return false;
  }
}

// Unicode whitespace, matching Python's str \s class (re module): the
// tokenizer spec (_WORD_RE in text/hash_tokenizer.py) treats every \s
// codepoint as a separator that emits NO symbol token.
bool is_unicode_space(uint32_t cp) {
  switch (cp) {
    case 0x09: case 0x0A: case 0x0B: case 0x0C: case 0x0D:
    case 0x1C: case 0x1D: case 0x1E: case 0x1F:
    case 0x20: case 0x85: case 0xA0:
    case 0x1680:
    case 0x2028: case 0x2029: case 0x202F: case 0x205F: case 0x3000:
      return true;
    default:
      return cp >= 0x2000 && cp <= 0x200A;
  }
}

uint32_t lower_cp(uint32_t cp) {
  if (cp >= 'A' && cp <= 'Z') return cp + 32;
  if (cp >= 0x00C0 && cp <= 0x00DE && cp != 0x00D7) return cp + 32;
  return cp;
}

// decode one UTF-8 codepoint; advances i; returns 0xFFFD on invalid bytes
uint32_t decode_utf8(const unsigned char* s, size_t len, size_t& i) {
  unsigned char c = s[i];
  if (c < 0x80) { i += 1; return c; }
  if ((c >> 5) == 0x6 && i + 1 < len) {
    uint32_t cp = ((c & 0x1F) << 6) | (s[i + 1] & 0x3F);
    i += 2; return cp;
  }
  if ((c >> 4) == 0xE && i + 2 < len) {
    uint32_t cp = ((c & 0x0F) << 12) | ((s[i + 1] & 0x3F) << 6) |
                  (s[i + 2] & 0x3F);
    i += 3; return cp;
  }
  if ((c >> 3) == 0x1E && i + 3 < len) {
    uint32_t cp = ((c & 0x07) << 18) | ((s[i + 1] & 0x3F) << 12) |
                  ((s[i + 2] & 0x3F) << 6) | (s[i + 3] & 0x3F);
    i += 4; return cp;
  }
  i += 1;
  return 0xFFFD;
}

void append_utf8(std::string& out, uint32_t cp) {
  if (cp < 0x80) {
    out.push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

// ---- tübingen normalization (analyzer.py _TUEBINGEN_RE) ------------------
// pattern: t(ü|ue|u)binge[nr]s?  (case handled by pre-lowercasing)
// applied as substring replacement inside each token.

const char* UML_UE = "\xC3\xBC";  // ü (lowercased already)

std::string normalize_tuebingen(const std::string& tok) {
  std::string out;
  size_t i = 0;
  const size_t n = tok.size();
  while (i < n) {
    if (tok[i] == 't') {
      size_t j = i + 1;
      bool stem = false;
      if (j + 1 < n && static_cast<unsigned char>(tok[j]) == 0xC3 &&
          static_cast<unsigned char>(tok[j + 1]) == 0xBC) {
        stem = true; j += 2;                 // tü
      } else if (tok.compare(j, 2, "ue") == 0) {
        stem = true; j += 2;                 // tue
      } else if (j < n && tok[j] == 'u') {
        stem = true; j += 1;                 // tu
      }
      if (stem && tok.compare(j, 5, "binge") == 0) {
        size_t k = j + 5;
        if (k < n && (tok[k] == 'n' || tok[k] == 'r')) {
          ++k;
          if (k < n && tok[k] == 's') ++k;
          out += "tuebingen";
          i = k;
          continue;
        }
      }
    }
    out.push_back(tok[i]);
    ++i;
  }
  return out;
}

// ---- stopwords (analyzer.py STOPWORDS, frozen) ---------------------------

const std::unordered_set<std::string>& stopwords() {
  static const std::unordered_set<std::string> S = {
    "a","about","above","after","again","against","all","am","an","and",
    "any","are","aren","as","at","be","because","been","before","being",
    "below","between","both","but","by","can","cannot","could","couldn",
    "did","didn","do","does","doesn","doing","don","down","during","each",
    "few","for","from","further","had","hadn","has","hasn","have","haven",
    "having","he","her","here","hers","herself","him","himself","his","how",
    "i","if","in","into","is","isn","it","its","itself","just","ll","m",
    "ma","me","mightn","more","most","mustn","my","myself","needn","no",
    "nor","not","now","o","of","off","on","once","only","or","other","our",
    "ours","ourselves","out","over","own","re","s","same","shan","she",
    "should","shouldn","so","some","such","t","than","that","the","their",
    "theirs","them","themselves","then","there","these","they","this",
    "those","through","to","too","under","until","up","ve","very","was",
    "wasn","we","were","weren","what","when","where","which","while","who",
    "whom","why","will","with","won","would","wouldn","y","you","your",
    "yours","yourself","yourselves"};
  return S;
}

// ---- lemma-light (analyzer.py _IRREGULAR + suffix rules) -----------------

const std::unordered_map<std::string, std::string>& irregular() {
  static const std::unordered_map<std::string, std::string> M = {
    {"is","be"},{"was","be"},{"are","be"},{"were","be"},{"been","be"},
    {"am","be"},{"being","be"},
    {"has","have"},{"had","have"},{"having","have"},
    {"does","do"},{"did","do"},{"done","do"},{"doing","do"},
    {"goes","go"},{"went","go"},{"gone","go"},{"going","go"},
    {"said","say"},{"says","say"},{"saying","say"},
    {"made","make"},{"making","make"},
    {"took","take"},{"taken","take"},{"taking","take"},
    {"came","come"},{"coming","come"},
    {"saw","see"},{"seen","see"},{"seeing","see"},
    {"got","get"},{"gotten","get"},{"getting","get"},
    {"gave","give"},{"given","give"},{"giving","give"},
    {"found","find"},{"finding","find"},
    {"knew","know"},{"known","know"},{"knowing","know"},
    {"thought","think"},{"thinking","think"},
    {"children","child"},{"men","man"},{"women","woman"},
    {"people","person"},{"feet","foot"},{"teeth","tooth"},
    {"mice","mouse"},{"geese","goose"},
    {"better","good"},{"best","good"},{"worse","bad"},{"worst","bad"},
    {"cities","city"},{"universities","university"},{"studies","study"},
    {"lives","life"},{"leaves","leaf"},
    // round-3 additions (docs/ANALYZER_DIVERGENCE.md) — keep identical
    // to analyzer.py _IRREGULAR
    {"built","build"},{"written","write"},{"wrote","write"},
    {"sent","send"},{"meant","mean"},{"drawn","draw"},{"drew","draw"},
    {"hidden","hide"},{"spent","spend"},{"kept","keep"},{"held","hold"},
    {"brought","bring"},{"bought","buy"},{"taught","teach"},
    {"caught","catch"},{"ran","run"},{"met","meet"},
    {"chose","choose"},{"chosen","choose"},{"choosing","choose"},
    {"data","datum"},{"media","medium"},
    {"vertices","vertex"},{"indices","index"},{"matrices","matrix"},
    {"axes","axis"},{"analyses","analysis"},{"hypotheses","hypothesis"},
    {"criteria","criterion"},{"maxima","maximum"},{"minima","minimum"},
    {"radii","radius"},{"corpora","corpus"}};
  return M;
}

// Frozen e-restoration table ("provided" -> "provid" -> "provide");
// keep identical to analyzer.py _E_RESTORE.
const std::unordered_set<std::string>& e_restore() {
  static const std::unordered_set<std::string> S = {
    "provid","defin","encod","bas","creat","includ","enabl","requir",
    "stor","pars","generat","distribut","shar","rais","introduc",
    "comput","execut","associat","sampl","advanc","updat","handl",
    "quantiz","chang","ignor","produc","compil","deprecat","reduc",
    "assum","determin","disabl","indicat","relat","remov","normaliz",
    "desir","declar","resolv","decod","initializ","clos","separat",
    "sav","combin","replac","complet","issu","decorat","cach","deriv",
    "invok","configur","receiv","captur","multisampl","rasteriz",
    "textur","instanc","mak","tak","writ","com","giv","hav","mov",
    "nam","cod","stat","liv","serv","styl","typ","siz","valu","scal",
    "pag","fil","not","merg","manag","invalidat","iterat","forc",
    "generaliz","overrid","notic","referenc","schedul","prun",
    "validat","evaluat","acceler","interpolat","accumul","propagat",
    "terminat","enumerat","instantiat","concatenat","serializ",
    "restor","compar","imag","shap","slic","pip","lin","scop","trac",
    "sourc","featur","measur","releas","packag","encourag","leverag",
    "integrat","migrat","consolidat",
    "tun","delet","populat","retriev","guarante","shad","rout","escap",
    "observ","prepar","pickl","templat","acquir","describ","truncat",
    "rotat","isolat","travers","activat","negat","locat","dictat",
    "delegat","navigat","calibrat","saturat","annotat","emulat",
    "improv","achiev","believ","involv","reserv","preserv","deserv",
    "compos","expos","propos","suppos","dispos","purg","surg","dodg",
    "judg","overwrit","rewrit","promot","demot","denot","quot","vot",
    "invit","excit","recit","composit","elevat","motivat","simulat",
    "stimulat","translat","relocat","allocat","deallocat","duplicat",
    "replicat","complicat","communicat","authenticat",
    "advis","devis","revis","prais","apprais","exercis","compris",
    "practis","incorporat","collaborat","elaborat","operat","cooperat",
    "disput","permut","transmut","pollut","dilut","persecut",
    "substitut","constitut","institut","attribut","contribut",
    "salut","refut","persuad","evad","invad","upgrad","degrad",
    "downgrad","cascad","subscrib","prescrib","transcrib","inscrib",
    "consum","resum","presum","subsum","perfum",
    "oppos","impos","transpos","juxtapos","superpos","predispos",
    "regenerat","degenerat","expir","inspir","aspir","conspir",
    "perspir","retir","admir","incit","ignit","unit","reunit",
    "accommodat","intimidat","liquidat","outdat","mandat",
    "sedat","elucidat","erod","explod","corrod","calculat","exclud"};
  return S;
}

// Doubled-"l" stems that undouble ("cancelled" -> "cancell" -> "cancel");
// the generic undoubling rule excludes final "l".  Keep identical to
// analyzer.py _UNDOUBLE_LL.
const std::unordered_set<std::string>& undouble_ll() {
  static const std::unordered_set<std::string> S = {
    "cancell","labell","modell","travell","controll","compell",
    "signall","equall"};
  return S;
}

std::string restore_e(const std::string& stem) {
  return e_restore().count(stem) ? stem + "e" : stem;
}

bool ends_with(const std::string& w, const char* suf) {
  size_t n = std::strlen(suf);
  return w.size() >= n && w.compare(w.size() - n, n, suf) == 0;
}

// NOTE: vowel test operates on UTF-8 bytes; multibyte vowels (äöü) are
// detected by their second byte.  Mirrors Python's set("aeiouäöü") checks.
bool byte_is_vowel_end(const std::string& s, size_t pos_end) {
  // is the character ending at byte index pos_end (exclusive) a vowel?
  if (pos_end == 0) return false;
  unsigned char b = s[pos_end - 1];
  if (b == 'a' || b == 'e' || b == 'i' || b == 'o' || b == 'u') return true;
  if (pos_end >= 2 && static_cast<unsigned char>(s[pos_end - 2]) == 0xC3 &&
      (b == 0xA4 || b == 0xB6 || b == 0xBC))  // ä ö ü
    return true;
  return false;
}

bool any_vowel(const std::string& s) {
  for (size_t i = 1; i <= s.size(); ++i)
    if (byte_is_vowel_end(s, i)) return true;
  return false;
}

size_t cp_length(const std::string& s) {
  size_t n = 0;
  for (size_t i = 0; i < s.size();) {
    unsigned char c = s[i];
    i += (c < 0x80) ? 1 : ((c >> 5) == 0x6 ? 2 : ((c >> 4) == 0xE ? 3 : 4));
    ++n;
  }
  return n;
}

std::string strip_suffix(const std::string& w) {
  size_t n = cp_length(w);
  if (n <= 3) return w;
  if (ends_with(w, "ies") && n > 4) return w.substr(0, w.size() - 3) + "y";
  if (ends_with(w, "sses")) return w.substr(0, w.size() - 2);
  if (ends_with(w, "xes") || ends_with(w, "zes") || ends_with(w, "ches") ||
      ends_with(w, "shes"))
    return w.substr(0, w.size() - 2);
  if (ends_with(w, "s") && !ends_with(w, "ss") && !ends_with(w, "us") &&
      !ends_with(w, "is"))
    return w.substr(0, w.size() - 1);
  return w;
}

std::string strip_verbal(const std::string& w) {
  size_t n = cp_length(w);
  if (n <= 4) return w;
  if (ends_with(w, "ing") && n >= 6) {
    std::string stem = w.substr(0, w.size() - 3);
    size_t sn = cp_length(stem);
    if (sn >= 3 && any_vowel(stem)) {
      char last = stem[stem.size() - 1];
      bool last_ascii = static_cast<unsigned char>(last) < 0x80;
      bool last_vowel = byte_is_vowel_end(stem, stem.size());
      // undouble only at stem length >= 4: "adding" -> "add", not "ad"
      if (sn >= 4 && last_ascii && stem.size() >= 2 &&
          stem[stem.size() - 1] == stem[stem.size() - 2] && !last_vowel &&
          last != 'l' && last != 's')
        return stem.substr(0, stem.size() - 1);
      if (undouble_ll().count(stem)) return stem.substr(0, stem.size() - 1);
      // dropped-e restoration by frozen table only (the old CVC guess
      // mangled short stems: "reading" -> "reade")
      return restore_e(stem);
    }
  }
  if (ends_with(w, "ed") && n >= 5) {
    std::string stem = w.substr(0, w.size() - 2);
    size_t sn = cp_length(stem);
    if (any_vowel(stem)) {
      char last = stem[stem.size() - 1];
      bool last_vowel = byte_is_vowel_end(stem, stem.size());
      if (sn >= 4 && stem.size() >= 2 &&
          stem[stem.size() - 1] == stem[stem.size() - 2] &&
          !last_vowel && last != 'l' && last != 's')
        return stem.substr(0, stem.size() - 1);
      if (undouble_ll().count(stem)) return stem.substr(0, stem.size() - 1);
      if (last == 'i') return stem.substr(0, stem.size() - 1) + "y";
      return restore_e(stem);
    }
  }
  return w;
}

std::string lemmatize(const std::string& w) {
  const auto& irr = irregular();
  auto it = irr.find(w);
  if (it != irr.end()) return it->second;
  std::string s = strip_suffix(w);
  it = irr.find(s);
  if (it != irr.end()) return it->second;
  return strip_verbal(s);
}

// Shared analyze scan: tokenizes/normalizes/lemmatizes and calls
// emit(lemma) for every surviving token, in document order.
template <typename F>
static void analyze_stream(const char* text, size_t len, F&& emit) {
  const unsigned char* s = reinterpret_cast<const unsigned char*>(text);
  std::string tok;
  size_t i = 0;
  const auto& stops = stopwords();

  auto flush = [&]() {
    if (tok.empty()) return;
    std::string t = normalize_tuebingen(tok);
    if (cp_length(t) >= 2 && !stops.count(t)) {
      std::string lemma = lemmatize(t);
      if (cp_length(lemma) >= 2 && !stops.count(lemma)) {
        emit(lemma);
      }
    }
    tok.clear();
  };

  // Truncate at MAX_DOC_CHARS CODEPOINTS (Python spec: text[:1M] counts
  // characters, not UTF-8 bytes — analyzer.py MAX_DOC_CHARS).
  size_t cp_count = 0;
  while (i < len && cp_count < MAX_DOC_CHARS) {
    size_t before = i;
    uint32_t cp = decode_utf8(s, len, i);
    if (i > len) { i = before + 1; cp = 0xFFFD; }
    ++cp_count;
    // lowercase BEFORE membership: the Python pipeline lowercases the whole
    // text before tokenizing, so uppercase accents (É) are in-class
    cp = lower_cp(cp);
    if (is_token_cp(cp)) {
      append_utf8(tok, cp);
    } else {
      flush();
    }
  }
  flush();
}

}  // namespace

extern "C" {

// Returns a newline-joined token list (malloc'd); caller frees.
char* msetpu_analyze(const char* text, size_t len) {
  std::string out;
  out.reserve(len / 4);
  analyze_stream(text, len, [&](const std::string& lemma) {
    out += lemma;
    out.push_back('\n');
  });
  char* ret = static_cast<char*>(std::malloc(out.size() + 1));
  std::memcpy(ret, out.data(), out.size());
  ret[out.size()] = '\0';
  return ret;
}

// Aggregated per-term counts: "term\tcount\n" per DISTINCT term (malloc'd;
// caller frees).  The BM25 build only needs counts, and shipping ~100
// distinct pairs instead of ~10x that many token strings moves the
// decode/split/Counter work out of Python (the doc-analysis hot loop).
char* msetpu_analyze_counts(const char* text, size_t len) {
  std::unordered_map<std::string, long long> counts;
  analyze_stream(text, len,
                 [&](const std::string& lemma) { ++counts[lemma]; });
  std::string out;
  out.reserve(counts.size() * 12);
  for (const auto& kv : counts) {
    out += kv.first;
    out.push_back('\t');
    out += std::to_string(kv.second);
    out.push_back('\n');
  }
  char* ret = static_cast<char*>(std::malloc(out.size() + 1));
  std::memcpy(ret, out.data(), out.size());
  ret[out.size()] = '\0';
  return ret;
}

void msetpu_free(char* p) { std::free(p); }

// ---- encoder hash-tokenization (text/hash_tokenizer.py fast path) --------
//
// Tokenizes with the encoder's word pattern (runs of letters/digits incl.
// the accent set, or a single non-space symbol), hashes each word with
// FNV-1a 64 over its lowercased UTF-8 bytes, and reports CODEPOINT offsets
// (parity with Python str slicing for lossless window texts).
//
// Output layout (malloc'd int64 array, caller frees with msetpu_free):
//   [n, id_0, start_0, end_0, id_1, start_1, end_1, ...]

static bool is_word_cp(uint32_t cp) {
  if (cp >= '0' && cp <= '9') return true;
  return is_token_cp(cp);  // letters incl. accents (already lowercased set
                           // covers both cases via lower_cp at call site)
}

long long* msetpu_hash_tokenize(const char* text, size_t len,
                                long long vocab_size) {
  const unsigned char* s = reinterpret_cast<const unsigned char*>(text);
  const uint64_t FNV_OFFSET = 0xCBF29CE484222325ULL;
  const uint64_t FNV_PRIME = 0x100000001B3ULL;
  const long long N_SPECIAL_IDS = 4;
  const long long mod = vocab_size - N_SPECIAL_IDS;

  std::vector<long long> out;
  out.reserve(len / 4 * 3 + 1);

  size_t i = 0;
  size_t cp_index = 0;
  uint64_t h = FNV_OFFSET;
  size_t tok_start_cp = 0;
  bool in_word = false;
  std::string lowered;

  auto flush_word = [&](size_t end_cp) {
    if (!in_word) return;
    uint64_t hh = FNV_OFFSET;
    for (unsigned char b : lowered) {
      hh ^= b;
      hh *= FNV_PRIME;
    }
    out.push_back(N_SPECIAL_IDS + (long long)(hh % (uint64_t)mod));
    out.push_back((long long)tok_start_cp);
    out.push_back((long long)end_cp);
    in_word = false;
    lowered.clear();
  };

  while (i < len) {
    size_t before = i;
    uint32_t cp = decode_utf8(s, len, i);
    if (i > len) { i = before + 1; cp = 0xFFFD; }
    uint32_t lcp = lower_cp(cp);
    // membership uses the RAW codepoint: the Python spec's word class is
    // [a-zA-Z0-9 + the explicit accent list]; uppercase accents outside it
    // (e.g. É) split words there, so they must split here too
    bool word_char = (cp >= '0' && cp <= '9') || is_token_cp(cp);
    if (word_char) {
      if (!in_word) {
        in_word = true;
        tok_start_cp = cp_index;
      }
      std::string tmp;
      append_utf8(tmp, lcp);
      lowered += tmp;
    } else {
      flush_word(cp_index);
      // single non-space symbol is its own token (hashed on its lowercase
      // UTF-8 bytes, like the Python tokenizer); full Unicode \s parity
      if (!is_unicode_space(cp) && cp != 0xFFFD) {
        std::string sym;
        append_utf8(sym, lcp);
        uint64_t hh = FNV_OFFSET;
        for (unsigned char b : sym) { hh ^= b; hh *= FNV_PRIME; }
        out.push_back(N_SPECIAL_IDS + (long long)(hh % (uint64_t)mod));
        out.push_back((long long)cp_index);
        out.push_back((long long)(cp_index + 1));
      }
    }
    ++cp_index;
  }
  flush_word(cp_index);

  size_t n = out.size() / 3;
  long long* ret = static_cast<long long*>(
      std::malloc(sizeof(long long) * (out.size() + 1)));
  ret[0] = (long long)n;
  std::memcpy(ret + 1, out.data(), sizeof(long long) * out.size());
  return ret;
}

}  // extern "C"
