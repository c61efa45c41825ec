"""Resource-configuration tuning (paper §IV-D): the Perona HPO
(``hpo``) and the machine scores that weight a tuner's acquisition
(``perona_weights``). CherryPick, Arrow and the scout dataset are not
ported yet."""
