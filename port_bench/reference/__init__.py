"""The benchmark's yardstick: a plain PyTorch reference of the solver
(``scp``), the test that counts a solve (``judge``), the comparison that
decides ``correct`` (``judge``) and the cost functions with the card's peaks
(``cost``).  Nothing here imports the program under test."""
