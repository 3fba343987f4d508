"""Input generators: the corpus (corpus.py) and the query pool
(queries.py), drawn from the seed."""
