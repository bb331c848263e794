"""Device time a prompt token of the prefill in the program's
``model.norm`` spans: every norm of every layer and the final one
(``spans.by_span``)."""

from chipbench import spans


def read(ctx):
    return spans.us_per_prompt_token(ctx, ("model.norm",))
