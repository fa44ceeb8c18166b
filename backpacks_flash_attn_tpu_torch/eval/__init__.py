from . import control, genderbias, perplexity, pplm, similarity, toxicity, visualize
