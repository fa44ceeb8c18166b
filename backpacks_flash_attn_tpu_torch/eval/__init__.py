from . import control, genderbias, perplexity, similarity, toxicity, visualize
