"""Graph partitioning (reference: src/sparsebase/partition/).

Only the multilevel helpers that nested dissection's numpy route needs are
here yet (``multilevel.py``); the partitioners and their exports come with
ROADMAP queue 1, item 8.
"""
