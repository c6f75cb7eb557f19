"""Symbol inventory for text input (counterpart of
unitspeech_tpu/text/symbols.py, which cannot be imported without jax: its
package __init__ imports the JAX masking ops).

The standard 179-symbol table of the VITS/Grad-TTS family (pad +
punctuation + Latin letters + IPA), ID-compatible with the reference's
text/symbols.py; a different order would permute the text-encoder
embeddings.
"""

PAD = "_"
PUNCTUATION = ';:,.!?¡¿—…"«»“” '
LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
LETTERS_IPA = (
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ̃"
)

symbols = [PAD] + list(PUNCTUATION) + list(LETTERS) + list(LETTERS_IPA)

BLANK_ID = len(symbols)  # interspersed blank token (= n_vocab - 1)
