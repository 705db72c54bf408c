"""The Uni-Prompt template ``"X X X X X X X X X X X X X X X X person."`` as
CLIP's BPE tokenizer writes it: start of text, sixteen "X" (the learned
context's places), "person", ".", end of text, zeros to 77."""

SOT, X, PERSON, DOT, EOT = 49406, 343, 2533, 269, 49407
N_CTX = 16  # 8 generic + 4 modality + 4 platform context vectors
N_GENERIC, N_MODAL, N_PLAT = 8, 4, 4


def template(length: int = 77) -> list:
    ids = [SOT] + [X] * N_CTX + [PERSON, DOT, EOT]
    return ids + [0] * (length - len(ids))


EOT_POSITION = 1 + N_CTX + 2
