"""The plain references, one module a configuration's scoring kind
(bm25.py), and their frozen spec (spec.py); nothing here imports the
program."""
