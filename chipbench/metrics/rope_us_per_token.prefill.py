"""Device time a prompt token of the prefill in the program's
``model.rope`` spans: the rotary embedding of q and k in every layer
(``spans.by_span``)."""

from chipbench import spans


def read(ctx):
    return spans.us_per_prompt_token(ctx, ("model.rope",))
