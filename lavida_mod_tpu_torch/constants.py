"""Model-wide constants: a copy of lavida_mod_tpu/constants.py.

Mirrors reference llava/constants.py:1-12 and the hard-coded token ids in
llava/model/language_model/llava_llada.py:125-127.
"""

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"

# LLaDA special token ids (reference llava_llada.py:125-127, generate.py:119)
LLADA_EOS_ID = 126081
LLADA_MASK_ID = 126336
LLADA_FIM_ID = 126085          # '<|reserved_token_1|>' infill marker
LLADA_FILL_ID = 126086         # '<|reserved_token_2|>' fill marker
LLADA_STOP_ID = 126348         # llada conversation stop id (conversation.py:474)
