"""The share of the rows the MoE expert layers computed that the routing
gave a weight of zero, in percent: 100 × (rows − routed) / rows over the
traced span's units. ``rows`` is the port's expert-layer counter
(``models/moe.py::expert_layers.rows``) as the program keeps it around each
unit (``programs/moe_train_epoch.py``); ``routed`` is what the routing
weights, tokens × top_k in every MoE layer, from the cell's config. Dense
dispatch of top-2 of 4 experts reads 50; a dispatch that computes only the
routed rows reads 0. None where the port has no such counter or the span
ran no expert layer."""


def routed_per_image(cfg) -> int:
    """Tokens × top_k × MoE layers of one training image."""
    (h, w), (sh, sw) = cfg.INPUT.SIZE_TRAIN, cfg.MODEL.STRIDE_SIZE
    tokens = ((h - 16) // sh + 1) * ((w - 16) // sw + 1) + 1
    return tokens * cfg.MODEL.MOE.TOP_K * cfg.MODEL.MOE.MOE_LAYERS


def read(rec):
    program = rec.context["program"]
    units = getattr(program, "expert_units", None)
    if not units:
        return None
    items = rows = 0
    for n, r in reversed(units):  # the span's units are the last ones run
        if items >= rec.items:
            break
        items, rows = items + n, rows + r
    if rows <= 0:
        return None
    return 100.0 * (rows - items * routed_per_image(program.ctx.cfg)) / rows
